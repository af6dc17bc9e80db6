"""Batched encoder: analysis, rate control and serialization per block.

Port of ``ulcx.codec.encoder``. CBR searches the coded-coefficient count
against the block's bit budget (reference ulcEncoder.c:93-116); ABR
scales the target rate by complexity / average complexity (:128-135);
VBR maps quality to a coefficient count analytically (:140-158) and
materializes it. The search follows ulcx's two paths, both on the same
walks (``bitstream.fast_encode``): the kernel path's plan, the seeded
ladder, where ulcx runs its kernels, and the scan path's, the exact
16-candidate ladder or the bisection, everywhere else. ``_use_kernel``
is ulcx's route between them.

``encode_stream_batched`` drives [B, T] blocks in one of two forms: a
Python loop over blocks carrying ``EncoderCarry``, the bitstream stages
run once per chunk of ``cfg.fold_bitstream`` blocks at fold * B streams
(1, the default: block by block); or, with ``cfg.flat_stream``,
everything but window control once over B * T streams. The route sees
the batch the bitstream stages run at. ``encode_stream`` codes one
stream as a batch of one, its block axis the batch; ``encode_block``
and ``encode_analyzed_cbr`` / ``_abr`` / ``_vbr`` are ulcx's
single-block forms, always on the scan path's plan.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ulcx_torch._build import kernels_on
from ulcx_torch.analysis.batched import analyze_block_batched, analyze_stream_batched
from ulcx_torch.analysis.block import AnalyzedBlock, EncoderCarry, analyze_block
from ulcx_torch.analysis.block import map_leaves as _map
from ulcx_torch.bitstream.fast_encode import (
    materialize_fast,
    prepare_fast,
    search_materialize_fast,
    search_materialize_scan,
)
from ulcx_torch.utils.config import CodecConfig
from ulcx_torch.utils.device import on_device
from ulcx_torch.utils.profiling import span

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


def _use_kernel(cfg: CodecConfig, batch: int) -> bool:
    """The plan a bitstream batch of ``batch`` streams takes: True the
    kernel path's (the seeded ladder), False the scan path's (the exact
    ladder, or the bisection). ulcx's ``encoder._use_kernel`` without its
    backend clause: a CPU tensor takes the route a CUDA one takes, so
    the CPU stands for the card (ulcx sends "auto" on the CPU to its
    scan path). "auto" takes the kernel path's plan where ulcx's kernels
    run: P <= 32768 and a multiple of 128, the segment window, a batch
    of a multiple of 8. "on" takes it at any batch and P up to 32768,
    where ulcx refuses a shape outside that envelope (the port's walks
    serve every shape); above P = 32768 and with the gap window there
    is no kernel plan ("on" with gap is refused by ``CodecConfig``).
    "off" always takes the scan path's plan. Whether the walks are the
    kernels or their plain versions is ``fast_encode.walks``'s choice."""
    if not kernels_on(cfg):
        return False
    p_tot = cfg.n_chan * cfg.block_size
    if p_tot > 32768 or cfg.noise_run_window != "segment":
        return False
    if cfg.use_pallas == "on":
        return True
    return p_tot % 128 == 0 and batch % 8 == 0


def _encode_analyzed_fast(blk: AnalyzedBlock, cfg: CodecConfig, mode: str, kernel: bool,
                          **kw) -> EncodedBlock:
    """Bitstream stages of a batch of analyzed blocks, on the kernel
    path's plan (``kernel``, see ``_use_kernel``) or the scan path's."""
    with span("ulcx.encode.bitstream"):
        fb = prepare_fast(blk, cfg)
        if mode == "vbr":
            size, data = materialize_fast(fb, _vbr_counts(blk, kw["quality"], cfg), cfg,
                                          max_block_bytes(cfg))
        elif mode in ("cbr", "abr"):
            rate = torch.tensor(float(kw["rate_kbps"]), dtype=_F32, device=blk.complexity.device)
            if mode == "abr":
                rate = rate * blk.complexity / torch.tensor(float(kw["avg_complexity"]), dtype=_F32)
            budget = cbr_bit_budget(cfg, rate).expand(blk.n_nz.shape)
            search = search_materialize_fast if kernel else search_materialize_scan
            _, size, data = search(fb, blk.n_nz, budget, cfg, max_block_bytes(cfg))
        else:
            raise ValueError(mode)
    return EncodedBlock(data, size, blk.complexity, blk.window_ctrl)


def _on_scan_plan(blk: AnalyzedBlock, cfg: CodecConfig, mode: str, **kw) -> EncodedBlock:
    """The scan path's plan for analyzed blocks with a leading [B], or
    for ulcx's single-block leaves (a 0-d window_ctrl) as a batch of one."""
    one = blk.window_ctrl.dim() == 0
    if one:
        blk = _map(lambda x: x[None], blk)
    enc = _encode_analyzed_fast(blk, cfg, mode, False, **kw)
    return _map(lambda x: x[0], enc) if one else enc


def encode_analyzed_cbr(blk: AnalyzedBlock, rate_kbps, cfg: CodecConfig) -> EncodedBlock:
    return _on_scan_plan(blk, cfg, "cbr", rate_kbps=rate_kbps)


def encode_analyzed_abr(blk: AnalyzedBlock, rate_kbps, avg_complexity, cfg: CodecConfig) -> EncodedBlock:
    return _on_scan_plan(blk, cfg, "abr", rate_kbps=rate_kbps, avg_complexity=avg_complexity)


def encode_analyzed_vbr(blk: AnalyzedBlock, quality, cfg: CodecConfig) -> EncodedBlock:
    return _on_scan_plan(blk, cfg, "vbr", quality=quality)


def _encode_analyzed(blk: AnalyzedBlock, cfg: CodecConfig, mode: str, **kw) -> EncodedBlock:
    if mode == "cbr":
        return encode_analyzed_cbr(blk, kw["rate_kbps"], cfg)
    if mode == "abr":
        return encode_analyzed_abr(blk, kw["rate_kbps"], kw["avg_complexity"], cfg)
    if mode == "vbr":
        return encode_analyzed_vbr(blk, kw["quality"], cfg)
    raise ValueError(mode)


def encode_block_batched(carry: EncoderCarry, new_blocks: torch.Tensor, cfg: CodecConfig,
                         mode: str, **kw):
    """One block step for a batch: carry with leading [B], new_blocks
    [B, C, N]. Returns (new carry, EncodedBlock with leading [B])."""
    with span("ulcx.encode"):
        carry, blk = analyze_block_batched(carry, new_blocks, cfg)
        return carry, _encode_analyzed_fast(blk, cfg, mode, _use_kernel(cfg, new_blocks.shape[0]),
                                            **kw)


def _stack(xs, dim: int):
    """A list of same-typed (possibly nested) NamedTuples of tensors ->
    one of them with every leaf stacked along ``dim``."""
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs, dim=dim)
    return type(xs[0])(*(_stack(list(leaf), dim) for leaf in zip(*xs)))


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
    walks are launched T / fold times, and the bytes do not depend on
    fold wherever B and fold * B streams take the same plan
    (``_use_kernel``; in ulcx alike). A fold that does not divide T
    counts as 1, block by block."""
    with span("ulcx.encode"):
        b, t = blocks.shape[0], blocks.shape[1]
        if carry is None:
            carry = init_carry_batched(cfg, b, blocks.device)

        if cfg.flat_stream:
            carry, blk = analyze_stream_batched(carry, blocks, cfg)
            enc = _encode_analyzed_fast(blk, cfg, mode, _use_kernel(cfg, b * t), **kw)
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
            encs.append(_encode_analyzed_fast(chunk, cfg, mode, _use_kernel(cfg, fold * b), **kw))
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
    chunk), the bitstream stages run once over all T blocks, and T
    routes them as ulcx's does: a call of a multiple of 8 blocks takes
    the kernel path's plan, any other call the scan path's. Analysis
    stays a per-block loop at the same shapes whatever T is, so a
    block's bytes depend on the chunking only through that plan: they
    do not change when the stream is cut into calls of multiples of 8
    blocks (the encode tool pads its last chunk to keep it so)."""
    blocks = on_device(blocks, device)
    if not cfg.flat_stream and cfg.fold_bitstream == 1:
        cfg = dataclasses.replace(cfg, fold_bitstream=blocks.shape[0])
    if carry is not None:
        carry = _map(lambda x: x.to(blocks.device)[None], carry)
    out, carry = encode_stream_batched(blocks[None], cfg, mode, carry=carry, **kw)
    return _map(lambda x: x[0], out), _map(lambda x: x[0], carry)


def encode_block(carry: EncoderCarry, new_block: torch.Tensor, cfg: CodecConfig, mode: str, **kw):
    """One block step of one stream, ulcx's form: ``analyze_block`` then
    the scan path's plan. carry without a batch axis, new_block [C, N].
    Returns (new carry, EncodedBlock), computed where ``new_block``
    lies. Its bytes are those of ``encode_stream`` wherever a call takes
    the scan path's plan (a call of a length that is no multiple of 8)."""
    with span("ulcx.encode"):
        carry, blk = analyze_block(carry, new_block, cfg)
        return carry, _encode_analyzed(blk, cfg, mode, **kw)
