"""The ULC block syntax, read token by token in plain Python.

A block (FormatSpecs.md:57-141) is a string of 4-bit nybbles, low nybble
of each byte first: the window control (one nybble, a second when its
bit 3 is set), then for each channel and each subblock of the window's
pattern a quantizer and a run of records until the subblock's positions
are filled or a stop ends it:

    2..7, 9..14      a coefficient s (9..14 read as s - 16), value s*|s| * 2^-(5+q)
    0 n              n + 1 zeros
    1 h l            (h << 4 | l) + 33 zeros
    8 h m x          a noise run of ((h << 5 | m << 1 | x & 1) + 16) positions at level (x >> 1) + 1
    F q | F E q'     a new quantizer (q < 14; q' + 14)
    F E F            stop: zeros to the subblock's end
    F F l h m        stop with decaying noise to the subblock's end

Noise signs come from one xorshift32 per stream (seed 1234567), one step
per noise position. ``parse_block`` reads the syntax; ``coefficients``
rebuilds the coefficients in float32 as the reference decoder
(ulcDecoder.c:99-197) computes them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from benchmarks.reference.transform import subblocks

SEED = 1234567

# record kinds
COEF, ZEROS, ZEROS_LONG, NOISE, QUANT, STOP, STOP_NOISE, END = range(8)
KIND_NAMES = ("coef", "zeros", "zeros_long", "noise", "quant", "stop", "stop_noise", "end")


class Block(NamedTuple):
    wc: int
    nybbles: int          # nybbles read, header included
    corrupt: bool
    records: list         # (kind, chan, pos, length, a, q): a = coefficient, level, or decay
    # a coefficient's q is the quantizer index (2^-(5+q)); a quantizer record's q the new one


def nybbles_of(data) -> list[int]:
    out = []
    for b in bytes(data):
        out.append(b & 0xF)
        out.append(b >> 4)
    return out


def parse_block(nyb: list[int], start: int, n: int, n_chan: int) -> Block:
    """The block whose first nybble is ``nyb[start]``. A block that reads
    past ``nyb`` or breaks the syntax comes back ``corrupt``."""
    pos = start

    def read():
        nonlocal pos
        if pos >= len(nyb):
            raise IndexError
        x = nyb[pos]
        pos += 1
        return x

    records = []
    wc = 0
    try:
        wc = read()
        wc = wc | (read() << 4) if wc & 0x8 else wc | 0x10
        for ch in range(n_chan):
            for off, size, _ in subblocks(wc, n):
                if not _segment(read, records, ch, off, size):
                    return Block(wc, pos - start, True, records)
    except IndexError:
        return Block(wc, pos - start, True, records)
    return Block(wc, pos - start, False, records)


def _quantizer(read):
    """A quantizer index, or "stop" / "stop_noise"."""
    q = read()
    if q == 0xF:
        return "stop_noise"
    if q == 0xE:
        q += read()
        if q == 0xE + 0xF:
            return "stop"
    return q


def _segment(read, records, ch, off, size) -> bool:
    end = off + size
    q = _quantizer(read)
    if q == "stop":
        records.append((STOP, ch, off, size, 0, 0))
        return True
    if q == "stop_noise":
        return False
    records.append((QUANT, ch, off, 0, 0, q))
    p = off
    while p < end:
        x = read()
        if x not in (0x0, 0x1, 0x8, 0xF):
            records.append((COEF, ch, p, 1, x - 16 if x & 0x8 else x, q))
            p += 1
        elif x == 0x0:
            cnt = read() + 1
            if p + cnt > end:
                return False
            records.append((ZEROS, ch, p, cnt, 0, q))
            p += cnt
        elif x == 0x1:
            cnt = ((read() << 4) | read()) + 33
            if p + cnt > end:
                return False
            records.append((ZEROS_LONG, ch, p, cnt, 0, q))
            p += cnt
        elif x == 0x8:
            hi, mid, lo = read(), read(), read()
            cnt = ((hi << 5) | (mid << 1) | (lo & 1)) + 16
            if p + cnt > end:
                return False
            records.append((NOISE, ch, p, cnt, (lo >> 1) + 1, q))
            p += cnt
        else:
            nq = _quantizer(read)
            if nq == "stop":
                records.append((STOP, ch, p, end - p, 0, q))
                return True
            if nq == "stop_noise":
                lvl = read() + 1
                decay = (read() << 4) | read()
                records.append((STOP_NOISE, ch, p, end - p, (lvl, decay), q))
                return True
            q = nq
            records.append((QUANT, ch, p, 0, 0, q))
    records.append((END, ch, end, 0, 0, q))
    return True


def _xorshift_bits(state: int, count: int) -> tuple[np.ndarray, int]:
    """The sign bits (bit 31) of ``count`` steps of xorshift32."""
    out = np.empty(count, bool)
    for i in range(count):
        state ^= (state << 13) & 0xFFFFFFFF
        state ^= state >> 17
        state ^= (state << 5) & 0xFFFFFFFF
        out[i] = bool(state & 0x80000000)
    return out, state


def coefficients(block: Block, n: int, n_chan: int, rng: int) -> tuple[np.ndarray, int]:
    """(coefficients [C, N] float32, the RNG state after the block) of a
    clean block, the RNG state ``rng`` before it."""
    out = np.zeros((n_chan, n), np.float32)
    f32 = np.float32
    for kind, ch, p, cnt, a, q in block.records:
        quant = f32(2.0 ** -(5 + q))
        if kind == COEF:
            out[ch, p] = f32(a * abs(a)) * quant
        elif kind == NOISE:
            flips, rng = _xorshift_bits(rng, cnt)
            amp = f32(a * a) * quant * f32(0.25)
            # each flip negates the running value for good
            sign = np.where(np.cumsum(flips) % 2 == 1, f32(-1), f32(1))
            out[ch, p:p + cnt] = sign * amp
        elif kind == STOP_NOISE:
            lvl, decay = a
            flips, rng = _xorshift_bits(rng, cnt)
            amp = f32(lvl * lvl) * quant * f32(1.0 / 16)
            r = f32(1.0) + f32(decay * decay) * f32(-(2.0 ** -19))
            # the reference multiplies the running value by r after each
            # position, in float32: a sequential product
            mags = np.multiply.accumulate(np.concatenate([[amp], np.full(cnt - 1, r, f32)]),
                                          dtype=f32) if cnt else np.zeros(0, f32)
            sign = np.where(np.cumsum(flips) % 2 == 1, f32(-1), f32(1))
            out[ch, p:p + cnt] = sign * mags
    return out, rng
