"""Batch entry points (single device).

Port of ``ulcx.parallel.mesh.batch_encode`` and ``batch_decode`` without
the mesh: streams are independent, so one device codes the whole batch.
Splitting the batch over several GPUs is later work (ROADMAP A.11).
"""

from __future__ import annotations

import torch

from ulcx_torch.codec.decoder import decode_stream_batched
from ulcx_torch.codec.encoder import encode_stream_batched
from ulcx_torch.utils.config import CodecConfig


def batch_encode(blocks, cfg: CodecConfig, mode: str, mesh=None, scan_major: bool = False, **kw):
    """Encode a batch of streams: blocks [B, T, C, N] -> (EncodedBlock
    with leading [B, T] ([T, B] with scan_major=True), stats). The
    device is the one ``blocks`` lies on."""
    if mesh is not None:
        raise NotImplementedError("multi-device batch_encode is not ported: ROADMAP A.11")
    blocks = torch.as_tensor(blocks)
    out, _ = encode_stream_batched(blocks, cfg, mode, scan_major=scan_major, **kw)
    stats = {
        "total_bits": torch.sum(out.size_bits),
        "avg_complexity": torch.mean(out.complexity),
    }
    return out, stats


def batch_decode(streams, n_blocks: int, window_bytes: int, cfg: CodecConfig, mesh=None):
    """Decode a batch of padded byte streams [B, S] uint8 -> (pcm
    [B, T, C, N], bits [B, T], corrupt [B, T]) with T = n_blocks, on the
    device ``streams`` lies on."""
    if mesh is not None:
        raise NotImplementedError("multi-device batch_decode is not ported: ROADMAP A.11")
    return decode_stream_batched(torch.as_tensor(streams), n_blocks, window_bytes, cfg)
