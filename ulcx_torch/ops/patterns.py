"""Window-switching decimation patterns.

The codec's window control nybble(s) select one of 16 subblock layouts
(reference libulc/ulcHelper.h:20-46 and FormatSpecs.md:30-55). Each
pattern packs up to 4 subblocks, 4 bits each (LSB first):

    bit0..2: subblock shift  (subblock size = block_size >> shift)
    bit3:    transient flag  (overlap scaling applies to this subblock)

A copy of ``ulcx.ops.patterns``: the tables are pure numpy, but that
module cannot be imported without jax (its package imports the DCT).
The pattern index (window_ctrl >> 4) selects one of 16 static layouts;
batched code gathers per-stream rows of tables built from them.
"""

from __future__ import annotations

import numpy as np

# Identical packed table to the reference (it is bitstream-defined data,
# not code: FormatSpecs.md's window table in packed form).
PATTERN_TABLE = (
    0x0000 | 0x0000,  # 0000: N/1 (unused; decoder maps 0 -> 1)
    0x0000 | 0x0008,  # 0001: N/1*
    0x0011 | 0x0008,  # 0010: N/2*,N/2
    0x0011 | 0x0080,  # 0011: N/2,N/2*
    0x0122 | 0x0008,  # 0100: N/4*,N/4,N/2
    0x0122 | 0x0080,  # 0101: N/4,N/4*,N/2
    0x0221 | 0x0080,  # 0110: N/2,N/4*,N/4
    0x0221 | 0x0800,  # 0111: N/2,N/4,N/4*
    0x1233 | 0x0008,  # 1000: N/8*,N/8,N/4,N/2
    0x1233 | 0x0080,  # 1001: N/8,N/8*,N/4,N/2
    0x1332 | 0x0080,  # 1010: N/4,N/8*,N/8,N/2
    0x1332 | 0x0800,  # 1011: N/4,N/8,N/8*,N/2
    0x2331 | 0x0080,  # 1100: N/2,N/8*,N/8,N/4
    0x2331 | 0x0800,  # 1101: N/2,N/8,N/8*,N/4
    0x3321 | 0x0800,  # 1110: N/2,N/4,N/8*,N/8
    0x3321 | 0x8000,  # 1111: N/2,N/4,N/8,N/8*
)


def decimation_pattern(pattern_idx: int) -> int:
    """Packed pattern word for window_ctrl>>4 (reference ulcHelper.h:45)."""
    return PATTERN_TABLE[pattern_idx]


def pattern_subblock_shifts(pattern_idx: int) -> tuple[int, ...]:
    """Static list of subblock shifts for a pattern index (python ints)."""
    pat = PATTERN_TABLE[pattern_idx]
    if pat == 0:
        return (0,)
    shifts = []
    while pat:
        shifts.append(pat & 0x7)
        pat >>= 4
    return tuple(shifts)


def pattern_transient_flags(pattern_idx: int) -> tuple[bool, ...]:
    """Which subblock carries the transient (overlap-scaled) window."""
    pat = PATTERN_TABLE[pattern_idx]
    if pat == 0:
        return (False,)
    flags = []
    while pat:
        flags.append(bool(pat & 0x8))
        pat >>= 4
    return tuple(flags)


def pattern_n_subblocks(pattern_idx: int) -> int:
    return len(pattern_subblock_shifts(pattern_idx))


def pattern_subblock_sizes(pattern_idx: int, block_size: int) -> tuple[int, ...]:
    return tuple(block_size >> s for s in pattern_subblock_shifts(pattern_idx))


def pattern_subblock_offsets(pattern_idx: int, block_size: int) -> tuple[int, ...]:
    offs, acc = [], 0
    for sz in pattern_subblock_sizes(pattern_idx, block_size):
        offs.append(acc)
        acc += sz
    assert acc == block_size
    return tuple(offs)


def subblock_index_map(pattern_idx: int, block_size: int) -> np.ndarray:
    """Per-coefficient subblock index [block_size] for a pattern (static)."""
    out = np.zeros(block_size, dtype=np.int32)
    for i, (off, sz) in enumerate(
        zip(
            pattern_subblock_offsets(pattern_idx, block_size),
            pattern_subblock_sizes(pattern_idx, block_size),
        )
    ):
        out[off : off + sz] = i
    return out
