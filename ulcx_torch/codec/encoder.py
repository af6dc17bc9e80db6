"""Batched encoder: analysis, rate control and serialization per block.

Port of the kernel path of ``ulcx.codec.encoder``. CBR searches the
coded-coefficient count against the block's bit budget (reference
ulcEncoder.c:93-116) with the seeded ladder; ABR scales the target rate
by complexity / average complexity (:128-135); VBR maps quality to a
coefficient count analytically (:140-158) and materializes it. The
block axis is a Python loop carrying ``EncoderCarry``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ulcx_torch.analysis.batched import analyze_block_batched
from ulcx_torch.analysis.block import AnalyzedBlock, EncoderCarry
from ulcx_torch.bitstream.fast_encode import (
    materialize_fast,
    prepare_fast,
    search_materialize_fast,
)
from ulcx_torch.utils.config import CodecConfig, check_supported

_E_TO_E = float(np.float32(float.fromhex("0x1.E4EFB7p3")))  # e^e
_F32 = torch.float32


class EncodedBlock(NamedTuple):
    data: torch.Tensor         # [..., max_bytes] uint8
    size_bits: torch.Tensor    # [...] int32 (byte aligned)
    complexity: torch.Tensor   # [...] f32
    window_ctrl: torch.Tensor  # [...] int32


def max_block_bytes(cfg: CodecConfig) -> int:
    """Static serialization buffer bound (nybbles can't exceed ~2.2/coef)."""
    return 2 * cfg.n_chan * cfg.block_size


def cbr_bit_budget(cfg: CodecConfig, rate_kbps) -> torch.Tensor:
    """Truncated bit budget per block (reference ulcEncoder.c:96), in f32
    as the reference computes it; ``rate_kbps`` a number or f32 tensor."""
    rate = torch.as_tensor(rate_kbps, dtype=_F32)
    n = torch.tensor(float(cfg.block_size), dtype=_F32, device=rate.device)
    k = torch.tensor(1000.0 / cfg.rate_hz, dtype=_F32, device=rate.device)
    return ((n * rate) * k).to(torch.int32)


def init_carry_batched(cfg: CodecConfig, batch: int, device="cuda") -> EncoderCarry:
    return EncoderCarry.init(cfg, batch, device)


def _vbr_counts(blk: AnalyzedBlock, quality, cfg: CodecConfig) -> torch.Tensor:
    dev = blk.complexity.device
    q = torch.tensor(float(quality), dtype=_F32, device=dev)
    target_cx = _E_TO_E * torch.log(100.0 / q)
    p_tot = cfg.n_chan * cfg.block_size
    f_target = float(p_tot) * blk.complexity / torch.where(target_cx > 0, target_cx, 1.0)
    return torch.where(
        (target_cx > 0) & (f_target < blk.n_nz.to(_F32)),
        f_target.to(torch.int32),
        blk.n_nz,
    )


def _encode_analyzed_fast(blk: AnalyzedBlock, cfg: CodecConfig, mode: str, **kw) -> EncodedBlock:
    """Bitstream stages of one block step (walks on the kernels)."""
    fb = prepare_fast(blk, cfg)
    if mode == "vbr":
        size, data = materialize_fast(fb, _vbr_counts(blk, kw["quality"], cfg), cfg, max_block_bytes(cfg))
    elif mode in ("cbr", "abr"):
        rate = torch.tensor(float(kw["rate_kbps"]), dtype=_F32, device=blk.complexity.device)
        if mode == "abr":
            rate = rate * blk.complexity / torch.tensor(float(kw["avg_complexity"]), dtype=_F32)
        budget = cbr_bit_budget(cfg, rate).expand(blk.n_nz.shape)
        _, size, data = search_materialize_fast(fb, blk.n_nz, budget, cfg, max_block_bytes(cfg))
    else:
        raise ValueError(mode)
    return EncodedBlock(data, size, blk.complexity, blk.window_ctrl)


def encode_block_batched(carry: EncoderCarry, new_blocks: torch.Tensor, cfg: CodecConfig,
                         mode: str, **kw):
    """One block step for a batch: carry with leading [B], new_blocks
    [B, C, N]. Returns (new carry, EncodedBlock with leading [B])."""
    check_supported(cfg)
    carry, blk = analyze_block_batched(carry, new_blocks, cfg)
    return carry, _encode_analyzed_fast(blk, cfg, mode, **kw)


def encode_stream_batched(blocks: torch.Tensor, cfg: CodecConfig, mode: str,
                          carry: EncoderCarry | None = None, scan_major: bool = False, **kw):
    """Encode [B, T, C, N] batched streams, block by block. Returns
    (EncodedBlock with leading [B, T] — [T, B] with scan_major=True —,
    final carry). Pass the carry back in to continue the streams."""
    check_supported(cfg)
    b, t = blocks.shape[0], blocks.shape[1]
    if carry is None:
        carry = init_carry_batched(cfg, b, blocks.device)
    outs = []
    for j in range(t):
        carry, enc = encode_block_batched(carry, blocks[:, j], cfg, mode, **kw)
        outs.append(enc)
    axis = 0 if scan_major else 1
    out = EncodedBlock(*(torch.stack(xs, dim=axis) for xs in zip(*outs)))
    return out, carry
