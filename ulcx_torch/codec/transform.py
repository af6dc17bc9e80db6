"""One stream's lapped transforms, and their per-pattern boundary lookups.

Port of ``ulcx.codec.transform``. window_ctrl encoding (reference
FormatSpecs.md:33-55): bits 0..2 overlap scale for the transient
subblock, bit 3 decimation toggle, bits 4..7 decimation pattern index.
``block_mdct_mdst`` and ``block_imdct`` take ulcx's single-stream
arguments (one window control for the block, leading axes before the
channel axis allowed) and run as a batch through
``codec.transform_batched``, which takes each stream's pattern from a
table rather than branching on it.
"""

from __future__ import annotations

import torch

from ulcx_torch.codec.transform_batched import (
    block_imdct_batched,
    block_mdct_mdst_batched,
    device_tables,
    last_size_of,
)


def first_overlap(window_ctrl: torch.Tensor, block_size: int) -> torch.Tensor:
    """Overlap a block requests at its leading boundary (pre-clamp)."""
    t = device_tables(block_size, window_ctrl.device)
    pat = (window_ctrl >> 4).long()
    scale = window_ctrl & 0x7
    sub = block_size >> t["first_shift"][pat]
    return sub >> torch.where(t["first_flag"][pat] == 1, scale, torch.zeros_like(scale))


def last_subblock_size(window_ctrl: torch.Tensor, block_size: int) -> torch.Tensor:
    """Final subblock size of each block's pattern: what the next
    block's overlap clamp sees (reference ulcDecoder.c:233-239)."""
    return last_size_of(window_ctrl, block_size)


def _per_row(x, like: torch.Tensor) -> torch.Tensor:
    """A 0-d block parameter, once for each row of ``like`` [rows, ...]."""
    return torch.as_tensor(x, dtype=torch.int32).to(like.device).reshape(1).expand(like.shape[0])


def block_mdct_mdst(samples, window_ctrl, prev_last_ss, next_overlap, cfg):
    """Forward transform of one stream's block: samples [..., C, 2N]
    (previous block, then this one), window_ctrl, prev_last_ss and
    next_overlap 0-d int32 (next_overlap before its clamp). Returns
    (mdct, mdst) [..., C, N], each normalized by 2/SubBlockSize."""
    lead, (c, n2) = samples.shape[:-2], samples.shape[-2:]
    x = samples.reshape(-1, c, n2)
    mdct, mdst = block_mdct_mdst_batched(x, _per_row(window_ctrl, x), _per_row(prev_last_ss, x),
                                         _per_row(next_overlap, x), cfg)
    return mdct.reshape(lead + (c, n2 // 2)), mdst.reshape(lead + (c, n2 // 2))


def block_imdct(coefs, window_ctrl, lap, prev_last_ss, cfg):
    """Inverse transform of one stream's block with its carried lap:
    coefs [..., C, N], window_ctrl and prev_last_ss 0-d int32, lap
    [..., C, N/2]. Returns (pcm [..., C, N], new lap [..., C, N/2],
    this block's last subblock size, 0-d int32)."""
    lead, (c, n) = coefs.shape[:-2], coefs.shape[-2:]
    x = coefs.reshape(-1, c, n)
    pcm, new_lap, last_ss = block_imdct_batched(x, _per_row(window_ctrl, x),
                                                lap.reshape(-1, c, n // 2),
                                                _per_row(prev_last_ss, x), cfg)
    return pcm.reshape(lead + (c, n)), new_lap.reshape(lead + (c, n // 2)), last_ss[0]
