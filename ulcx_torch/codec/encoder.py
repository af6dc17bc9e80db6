"""Batched encoder: analysis, rate control and serialization per block.

Port of the kernel path of ``ulcx.codec.encoder``. CBR searches the
coded-coefficient count against the block's bit budget (reference
ulcEncoder.c:93-116) with the seeded ladder; ABR scales the target rate
by complexity / average complexity (:128-135); VBR maps quality to a
coefficient count analytically (:140-158) and materializes it.

``encode_stream_batched`` drives [B, T] blocks in one of two forms: a
Python loop over blocks carrying ``EncoderCarry``, the bitstream stages
run once per chunk of ``cfg.fold_bitstream`` blocks at fold * B streams
(1, the default: block by block; any fold gives the same bytes); or,
with ``cfg.flat_stream``, everything but window control once over B * T
streams. ``encode_stream`` and ``encode_block`` code one stream as a
batch of one.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ulcx_torch.analysis.batched import analyze_block_batched, analyze_stream_batched
from ulcx_torch.analysis.block import AnalyzedBlock, EncoderCarry
from ulcx_torch.bitstream.fast_encode import (
    materialize_fast,
    prepare_fast,
    search_materialize_fast,
)
from ulcx_torch.utils.config import CodecConfig
from ulcx_torch.utils.device import on_device

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
    carry, blk = analyze_block_batched(carry, new_blocks, cfg)
    return carry, _encode_analyzed_fast(blk, cfg, mode, **kw)


def _stack(xs, dim: int):
    """A list of same-typed (possibly nested) NamedTuples of tensors ->
    one of them with every leaf stacked along ``dim``."""
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs, dim=dim)
    return type(xs[0])(*(_stack(list(leaf), dim) for leaf in zip(*xs)))


def _map(fn, x):
    """``fn`` over every tensor leaf of a (possibly nested) NamedTuple."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    return type(x)(*(_map(fn, leaf) for leaf in x))


def encode_stream_batched(blocks: torch.Tensor, cfg: CodecConfig, mode: str,
                          carry: EncoderCarry | None = None, scan_major: bool = False, **kw):
    """Encode [B, T, C, N] batched streams. Returns (EncodedBlock with
    leading [B, T] — [T, B] with scan_major=True —, final carry). Pass
    the carry back in to continue the streams.

    With ``cfg.flat_stream`` only window control loops over blocks and
    the rest runs once over the flat [B*T] batch. Window control is the
    per-block loop's. Bytes and sizes are too wherever the transform
    products do not depend on the batch (the CPU); a card's GEMM sums
    B*T rows in another order than B rows, which flips float near-ties
    of the importance order: other, equally valid bytes, sizes within a
    few bytes a block (``devtools/torch_flat_nearties.py``).
    Else analysis is a per-block loop and the bitstream stages run once
    per chunk of ``cfg.fold_bitstream`` blocks at fold * B streams: the
    walks are launched T / fold times and the bytes do not depend on
    fold. A fold that does not divide T counts as 1, block by block."""
    b, t = blocks.shape[0], blocks.shape[1]
    if carry is None:
        carry = init_carry_batched(cfg, b, blocks.device)

    if cfg.flat_stream:
        carry, blk = analyze_stream_batched(carry, blocks, cfg)
        enc = _encode_analyzed_fast(blk, cfg, mode, **kw)
        out = _map(lambda x: x.reshape((b, t) + x.shape[1:]), enc)
        if scan_major:
            out = _map(lambda x: x.transpose(0, 1), out)
        return out, carry

    # one loop: analysis block by block, the bitstream stages once per
    # chunk of fold blocks. Streams are independent, so a chunk's [fold, B]
    # blocks are one batch of fold * B streams (fold = 1: block by block)
    fold = cfg.fold_bitstream if t % cfg.fold_bitstream == 0 else 1
    encs = []
    for j in range(0, t, fold):
        blks = []
        for k in range(j, j + fold):
            carry, blk = analyze_block_batched(carry, blocks[:, k], cfg)
            blks.append(blk)
        chunk = _map(lambda x: x.flatten(0, 1), _stack(blks, 0))
        encs.append(_encode_analyzed_fast(chunk, cfg, mode, **kw))
    out = _map(lambda x: x.reshape((t, b) + x.shape[2:]), _stack(encs, 0))
    if not scan_major:
        out = _map(lambda x: x.transpose(0, 1), out)
    return out, carry


def encode_stream(blocks, cfg: CodecConfig, mode: str, carry: EncoderCarry | None = None,
                  device="cuda", **kw):
    """Encode [T, C, N] deinterleaved PCM blocks of one stream on
    ``device``. Returns (EncodedBlock stacked over T, final carry
    without a batch axis); pass the carry back in to continue the
    stream chunk by chunk.

    One stream is a batch of one, so the block axis takes the batch's
    place: unless the caller set ``flat_stream`` or a ``fold_bitstream``
    of their own (say, to bound the walk planes' memory on a long
    chunk), the bitstream stages run once over all T blocks. Analysis
    stays a per-block loop at the same shapes whatever T is, so the
    bytes do not depend on how the stream is chunked."""
    blocks = on_device(blocks, device)
    if not cfg.flat_stream and cfg.fold_bitstream == 1:
        cfg = dataclasses.replace(cfg, fold_bitstream=blocks.shape[0])
    if carry is not None:
        carry = _map(lambda x: x.to(blocks.device)[None], carry)
    out, carry = encode_stream_batched(blocks[None], cfg, mode, carry=carry, **kw)
    return _map(lambda x: x[0], out), _map(lambda x: x[0], carry)


def encode_block(carry: EncoderCarry, new_block: torch.Tensor, cfg: CodecConfig, mode: str, **kw):
    """One block step of one stream: carry without a batch axis,
    new_block [C, N]. Returns (new carry, EncodedBlock), computed where
    ``new_block`` lies."""
    carry = _map(lambda x: x[None], carry)
    carry, enc = encode_block_batched(carry, new_block[None], cfg, mode, **kw)
    return _map(lambda x: x[0], carry), _map(lambda x: x[0], enc)
