"""Batch entry points (single device).

Port of ``ulcx.parallel.mesh.batch_encode`` and ``batch_decode`` without
the mesh: streams are independent, so one device codes the whole batch.
Splitting the batch over several GPUs is later work (ROADMAP A.11).

Both run on the card unless the caller passes ``device="cpu"``; with no
card, the default raises rather than falling back to the CPU
(``utils.device.on_device``).
"""

from __future__ import annotations

import torch

from ulcx_torch.codec.decoder import decode_stream_batched
from ulcx_torch.codec.encoder import encode_stream_batched
from ulcx_torch.utils.config import CodecConfig
from ulcx_torch.utils.device import on_device


def batch_encode(blocks, cfg: CodecConfig, mode: str, mesh=None, scan_major: bool = False,
                 device="cuda", **kw):
    """Encode a batch of streams: blocks [B, T, C, N] -> (EncodedBlock
    with leading [B, T] ([T, B] with scan_major=True), stats), computed
    on ``device``."""
    if mesh is not None:
        raise NotImplementedError("multi-device batch_encode is not ported: ROADMAP A.11")
    out, _ = encode_stream_batched(on_device(blocks, device), cfg, mode, scan_major=scan_major, **kw)
    stats = {
        "total_bits": torch.sum(out.size_bits),
        "avg_complexity": torch.mean(out.complexity),
    }
    return out, stats


def batch_decode(streams, n_blocks: int, window_bytes: int, cfg: CodecConfig, mesh=None,
                 device="cuda"):
    """Decode a batch of padded byte streams [B, S] uint8 -> (pcm
    [B, T, C, N], bits [B, T], corrupt [B, T]) with T = n_blocks,
    computed on ``device``."""
    if mesh is not None:
        raise NotImplementedError("multi-device batch_decode is not ported: ROADMAP A.11")
    return decode_stream_batched(on_device(streams, device), n_blocks, window_bytes, cfg)
