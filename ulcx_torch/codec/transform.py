"""Per-pattern boundary lookups of the lapped transform.

Port of the two table lookups of ``ulcx.codec.transform`` that the
batched encoder needs. window_ctrl encoding (reference
FormatSpecs.md:33-55): bits 0..2 overlap scale for the transient
subblock, bit 3 decimation toggle, bits 4..7 decimation pattern index.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ulcx_torch.ops.patterns import PATTERN_TABLE, pattern_subblock_sizes


@lru_cache(maxsize=16)
def _first_tables(device: torch.device):
    """(shift, transient flag) of each pattern's first subblock."""
    shift0 = np.array([PATTERN_TABLE[i] & 0x7 for i in range(16)], np.int32)
    flag0 = np.array([(PATTERN_TABLE[i] >> 3) & 1 for i in range(16)], np.int32)
    return torch.from_numpy(shift0).to(device), torch.from_numpy(flag0).to(device)


@lru_cache(maxsize=16)
def _last_sizes(block_size: int, device: torch.device):
    sizes = [pattern_subblock_sizes(i or 1, block_size)[-1] for i in range(16)]
    return torch.tensor(sizes, dtype=torch.int32, device=device)


def first_overlap(window_ctrl: torch.Tensor, block_size: int) -> torch.Tensor:
    """Overlap a block requests at its leading boundary (pre-clamp)."""
    shift0, flag0 = _first_tables(window_ctrl.device)
    pat = (window_ctrl >> 4).long()
    scale = window_ctrl & 0x7
    sub = block_size >> shift0[pat]
    return sub >> torch.where(flag0[pat] == 1, scale, torch.zeros_like(scale))


def last_subblock_size(window_ctrl: torch.Tensor, block_size: int) -> torch.Tensor:
    """Final subblock size of each block's pattern: what the next
    block's overlap clamp sees (reference ulcDecoder.c:233-239)."""
    return _last_sizes(block_size, window_ctrl.device)[(window_ctrl >> 4).long()]
