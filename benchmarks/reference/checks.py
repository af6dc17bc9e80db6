"""The comparisons that decide ``correct``, against the plain reference.

Encode: every sampled block must read back clean by the reference
syntax, its bits rounded up to bytes equal to the size the program
reported; and each coefficient the block codes must be the companded
quantization (q = floor(1/2 + sqrt(|x| 2^Q - 1/4)), at most 7, the sign
of x) of the reference's float64 coefficient x at the block's coded
quantizer Q, the coefficient computed from the input PCM with the window
controls that the program's own bytes of this, the previous and the next
block give. Which coefficients the block codes is the program's choice
(psychoacoustics and the rate search); what it codes for them is
checked. A coefficient within float rounding of a step between two
levels may come out on either side, so the number compared is the share
that differ.

The window controls that the sampled streams' bytes declare must be
those of the float64 detector (``window.py``) run over the same PCM from
each stream's start; a decision within float rounding of a threshold may
fall either way, so the number compared is the share that differ.

Decode: the reference reads each stream from its start (syntax, noise
draws, dequantization in float32 as the C decoder computes them), then
synthesizes in float64 (``transform.synthesize``). The program's bits
and corrupt flags must equal the reference's; its PCM must lie within a
limit of the reference's, as a share of the block's largest magnitude,
and every PCM sample must be finite.
"""

from __future__ import annotations

import numpy as np

from benchmarks.reference import syntax, transform, window


def companded(x: np.ndarray) -> np.ndarray:
    """The coded value of scaled coefficients x (float64): -7..7."""
    v = np.abs(x)
    q = np.where(v >= 0.5, np.floor(0.5 + np.sqrt(np.maximum(v - 0.25, 0.0))), 0.0)
    return (np.sign(x) * np.minimum(q, 7)).astype(np.int64)


def header_wc(data: np.ndarray) -> int:
    """A block's window control from its first byte(s)."""
    lo = int(data[0]) & 0xF
    return lo | (int(data[0]) >> 4) << 4 if lo & 0x8 else lo | 0x10


def encode_numbers(blocks: dict, pcm: dict, checked: list, n: int, n_chan: int) -> dict:
    """blocks[s][i] = (bytes uint8, size_bits) of stream s's block i from
    its start; pcm[s] [L, C, N] the PCM pool stream s cycles through
    (block i is pool block i % L); checked: the (s, i) to compare, each
    with a block after it. Returns {"bad_blocks", "requant_mismatch",
    "coded"}."""
    bad = mismatch = coded = 0
    for s, i in checked:
        data, size = blocks[s][i]
        blk = syntax.parse_block(syntax.nybbles_of(data), 0, n, n_chan)
        if blk.corrupt or (4 * blk.nybbles + 7) // 8 * 8 != size:
            bad += 1
            continue
        pool = pcm[s]
        prev = pool[(i - 1) % len(pool)] if i > 0 else np.zeros((n_chan, n))
        wc_prev = header_wc(blocks[s][i - 1][0]) if i > 0 else None
        ref = transform.block_coefficients(prev.astype(np.float64), pool[i % len(pool)].astype(np.float64),
                                           wc_prev, blk.wc, header_wc(blocks[s][i + 1][0]))
        rec = np.array([(ch, p, a, q) for kind, ch, p, _, a, q in blk.records if kind == syntax.COEF],
                       np.int64).reshape(-1, 4)
        want = companded(ref[rec[:, 0], rec[:, 1]] * np.exp2(rec[:, 3] + 5.0))
        mismatch += int(np.sum(want != rec[:, 2]))
        coded += len(rec)
    return {"bad_blocks": bad, "requant_mismatch": mismatch / max(coded, 1), "coded": coded}


def window_mismatch(blocks: dict, pcm: dict, first: int, end: int, rate_hz: int) -> float:
    """The share of blocks first .. end - 1 of the sampled streams
    (``blocks`` and ``pcm`` as for ``encode_numbers``) whose window
    control differs from the reference detector's."""
    streams = sorted(blocks)
    want = window.window_controls(np.stack([pcm[s] for s in streams]), end, rate_hz)
    got = np.array([[header_wc(blocks[s][i][0]) for i in range(first, end)] for s in streams])
    return float(np.mean(got != want[:, first:]))


def decode_stream(data: np.ndarray, t_blocks: int, n: int, n_chan: int, pcm: bool):
    """The reference's (bits [T], corrupt [T], PCM [T, C, N] or None) of
    a byte stream's first T blocks."""
    nyb = syntax.nybbles_of(data)
    pos, rng = 0, syntax.SEED
    bits = np.zeros(t_blocks, np.int64)
    corrupt = np.zeros(t_blocks, bool)
    coefs, wcs = np.zeros((t_blocks, n_chan, n), np.float32), []
    for t in range(t_blocks):
        blk = syntax.parse_block(nyb, pos, n, n_chan)
        bits[t], corrupt[t] = 4 * blk.nybbles, blk.corrupt
        wcs.append(blk.wc)
        if pcm and not blk.corrupt:
            coefs[t], rng = syntax.coefficients(blk, n, n_chan, rng)
        pos += 2 * ((blk.nybbles + 1) // 2)
    return bits, corrupt, (transform.synthesize(coefs, wcs) if pcm else None)


def pcm_gap(program: np.ndarray, reference: np.ndarray) -> float:
    """The widest gap of [T, C, N] PCM, over each block's largest
    reference magnitude (at least 1e-3 of full scale), of the program's
    finite samples (``nonfinite`` counts the others)."""
    peak = np.maximum(np.abs(reference).max(axis=(1, 2)), 1e-3)
    gap = np.where(np.isfinite(program), np.abs(program - reference), 0.0)
    return float((gap.max(axis=(1, 2)) / peak).max())


def nonfinite(program: np.ndarray) -> int:
    """The program's PCM samples that are NaN or infinite."""
    return int(np.sum(~np.isfinite(program)))
