"""A plain bitstream writer for the decode traffic, vectorised over blocks.

It writes legal ULC blocks (the syntax in ``reference/syntax.py``)
without any analysis: the window control, quantizers and records are
drawn from the seed in the shares a traffic file's ``mix`` gives, which
``benchmarks/mix.py`` measured once from the port's CBR output on the
corpus. Every block fills its bit budget: each channel's subblocks share
the block's nybbles in proportion to their size, and a subblock's
records keep at least as many positions left as nybbles, so that
coefficients can always spend what is left before the stop that closes
the subblock. The decoder's work (the records, their runs and noise
draws, the window switching) so does not depend on the encoder's
version.
"""

from __future__ import annotations

import numpy as np

from benchmarks.reference.transform import PATTERNS

RECORDS = ("coef", "zeros", "zeros_long", "noise", "quant")
# positions a record may cover, before the clamp that keeps the invariant
RUN_RANGE = {"zeros": (1, 16), "zeros_long": (33, 288), "noise": (16, 527)}


def _subblock_table(n: int, n_chan: int):
    """Per pattern [16, 4 * C] slot sizes (0: no such slot), slots
    channel-major: for each channel the pattern's subblocks in order."""
    sizes = np.zeros((16, 4 * n_chan), np.int64)
    for pat in range(1, 16):
        word, k = PATTERNS[pat], 0
        while word:
            for ch in range(n_chan):
                sizes[pat, ch * 4 + k] = n >> (word & 0x7)
            word >>= 4
            k += 1
    return sizes


def _draw(rng, weights: dict, keys, size):
    """``size`` indices into ``keys``, drawn with the weights given by name."""
    cum = np.cumsum([float(weights.get(k, 0)) for k in keys])
    return np.minimum(np.searchsorted(cum / cum[-1], rng.random(size), side="right"), len(keys) - 1)


def generate_blocks(rng: np.random.Generator, rows: int, n: int, n_chan: int, budget_bits: int,
                    mix: dict, force_patterns: bool = True):
    """``rows`` blocks. Returns (nybbles [rows, budget_bits // 4] uint8,
    count [rows] nybbles written, window control [rows])."""
    cap = budget_bits // 4
    nyb = np.zeros((rows, cap + 8), np.uint8)
    w = np.zeros(rows, np.int64)
    idx = np.arange(rows)

    def emit(mask, values):
        """Write len(values) nybbles (arrays over ``rows``) where mask."""
        r = idx[mask]
        for i, v in enumerate(values):
            nyb[r, w[r] + i] = np.broadcast_to(v, (rows,))[r]
        w[r] += len(values)

    # window control: transient blocks take a pattern 2..15, the others 1
    transient = rng.random(rows) < float(mix["transient_share"])
    pats = np.where(transient, 2 + _draw(rng, mix["patterns"], [str(p) for p in range(2, 16)], rows), 1)
    scale = np.where(transient, _draw(rng, mix["transient_scales"], [str(s) for s in range(8)], rows),
                     _draw(rng, mix["steady_scales"], [str(s) for s in range(8)], rows))
    if force_patterns:  # every pattern at least once
        k = min(14, rows)
        pats[:k], transient[:k] = 2 + np.arange(k), True
    wc = (pats << 4) | scale | np.where(transient, 0x8, 0)
    emit(transient, [0x8 | scale, pats])
    emit(~transient, [scale])

    sizes = _subblock_table(n, n_chan)[pats]  # [rows, 4C]
    total = cap - w  # nybbles left for the segments
    carry = np.zeros(rows, np.int64)
    last_slot = sizes.shape[1] - 1 - np.argmax(sizes[:, ::-1] > 0, axis=1)
    q_keys = [str(q) for q in range(27)]
    kinds = list(RECORDS)
    mags = np.array([2, 3, 4, 5, 6, 7])
    for slot in range(sizes.shape[1]):
        live = sizes[:, slot] > 0
        share = np.where(live, total * sizes[:, slot] // (n_chan * n), 0) + carry
        share = np.where(slot == last_slot, cap - w, share)  # the last subblock takes the rest
        carry = np.where(live, 0, carry)
        stop_noise = rng.random(rows) < float(mix["stop_noise_share"])
        reserve = np.where(stop_noise, 5, 3)
        q = _draw(rng, mix["quantizers"], q_keys, rows)
        emit(live & (q < 14), [q])
        emit(live & (q >= 14), [0xE, q - 14])
        allow = share - reserve - np.where(q < 14, 1, 2)  # the A of the invariant R >= A
        left = sizes[:, slot].copy()  # R
        going = live.copy()
        while going.any():
            # spent: close the subblock with its stop; where the positions
            # ran out with the nybbles (left >= allow), without one
            end = going & ((allow <= 0) | (left == 0))
            emit(end & (left > 0) & ~stop_noise, [0xF, 0xE, 0xF])
            sn = end & (left > 0) & stop_noise
            emit(sn, [0xF, 0xF, rng.integers(0, 16, rows), rng.integers(0, 16, rows),
                      rng.integers(0, 16, rows)])
            carry = np.where(end & (left == 0), carry + reserve, carry)
            going &= ~end
            if not going.any():
                break
            kind = _draw(rng, mix["records"], kinds, rows)
            slack = left - allow  # >= 0: positions beyond one a nybble
            run = np.zeros(rows, np.int64)
            cost = np.ones(rows, np.int64)
            for k, name in enumerate(kinds[1:4], start=1):
                lo, hi = RUN_RANGE[name]
                mean = float(mix["run_means"].get(name, (lo + hi) / 2))
                draw = rng.integers(lo, max(lo, min(hi, int(round(2 * mean)) - lo)) + 1, rows)
                nybs = {"zeros": 2, "zeros_long": 3, "noise": 4}[name]
                fits = (kind == k) & (allow >= nybs) & (slack + nybs >= lo)
                run = np.where(fits, np.minimum(draw, slack + nybs), run)
                cost = np.where(fits, nybs, cost)
                kind = np.where((kind == k) & ~fits, 0, kind)
            qn = _draw(rng, mix["quantizers"], q_keys, rows)
            qfits = (kind == 4) & (allow >= np.where(qn < 14, 2, 3))
            kind = np.where((kind == 4) & ~qfits, 0, kind)
            cost = np.where(kind == 4, np.where(qn < 14, 2, 3), cost)
            run = np.where(kind == 0, 1, run)
            s = mags[_draw(rng, mix["coefficients"], [str(m) for m in mags], rows)]
            s = np.where(rng.random(rows) < 0.5, s, 16 - s)  # -s written as 16 - s
            g = going
            emit(g & (kind == 0), [s])
            emit(g & (kind == 1), [0x0, run - 1])
            v = run - 33
            emit(g & (kind == 2), [0x1, v >> 4, v & 0xF])
            v = run - 16
            emit(g & (kind == 3), [0x8, v >> 5, (v >> 1) & 0xF, (v & 1) | (rng.integers(0, 8, rows) << 1)])
            emit(g & (kind == 4) & (qn < 14), [0xF, qn])
            emit(g & (kind == 4) & (qn >= 14), [0xF, 0xE, qn - 14])
            allow = np.where(g, allow - cost, allow)
            left = np.where(g, left - run, left)
    return nyb[:, :cap], w, wc


def pack_streams(nyb: np.ndarray, count: np.ndarray, n_streams: int, n_blocks: int):
    """Blocks [n_streams * n_blocks, cap] (stream-major) -> (streams
    [n_streams, S] uint8, block bits [n_streams, n_blocks], window bytes
    as the decode bench sizes it: the largest block rounded up to 64
    bytes, plus 64)."""
    nbytes = (count + 1) // 2
    win = -(-int(nbytes.max()) // 64) * 64 + 64
    streams = np.zeros((n_streams, n_blocks * win + win + 64), np.uint8)
    for s in range(n_streams):
        off = 0
        for t in range(n_blocks):
            r = s * n_blocks + t
            nb = int(nbytes[r])
            lo = nyb[r, 0:2 * nb:2].astype(np.uint8)
            hi = nyb[r, 1:2 * nb:2].astype(np.uint8)
            streams[s, off:off + nb] = lo | (hi << 4)
            off += nb
    return streams, (4 * count).reshape(n_streams, n_blocks), win
