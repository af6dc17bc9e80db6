"""Static per-pattern coefficient tables for the bitstream passes.

The bitstream is structured per (channel, subblock) segment; these host
tables map every flat coefficient index to its segment bounds for each
of the 16 window patterns, so the batched passes gather them by the
per-stream pattern index instead of branching. A copy of
``ulcx.bitstream.tables``, which cannot be imported without jax.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ulcx_torch.ops.patterns import pattern_subblock_offsets, pattern_subblock_sizes


@lru_cache(maxsize=32)
def segment_tables(block_size: int, n_chan: int):
    """(seg_start[16, C*N], seg_end[16, C*N], seg_id[16, C*N]) int32.

    Flat coefficient order is channel-major; segment = one subblock of
    one channel, in stream order (reference ULCi_EncodePass walks
    channels then subblocks; ulcEncoder_Encode.c:336-354).
    """
    n = block_size
    p_tot = n * n_chan
    starts = np.zeros((16, p_tot), np.int32)
    ends = np.zeros((16, p_tot), np.int32)
    sids = np.zeros((16, p_tot), np.int32)
    for pat in range(16):
        pi = pat or 1
        offs = pattern_subblock_offsets(pi, n)
        szs = pattern_subblock_sizes(pi, n)
        sid = 0
        for c in range(n_chan):
            base = c * n
            for off, ss in zip(offs, szs):
                sl = slice(base + off, base + off + ss)
                starts[pat, sl] = base + off
                ends[pat, sl] = base + off + ss
                sids[pat, sl] = sid
                sid += 1
    return starts, ends, sids
