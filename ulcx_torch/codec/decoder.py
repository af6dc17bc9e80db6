"""Batched stream decoder: bitstream -> coefficients -> IMDCT -> PCM.

Port of the kernel path of ``ulcx.codec.decoder`` (reference
ULC_DecodeBlock, ulcDecoder.c:198-302): per block, the FSM and
RNG-expand kernels give the coefficients, the batched inverse transform
laps them with the previous block, and the pairwise M/S is undone. The
block axis is a Python loop; each stream's byte offset advances by its
block's whole bytes. The single-stream ``decode_block``/``decode_stream``
and ``decode_stream_pipelined`` are later work (ROADMAP A.8, A.9).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ulcx_torch.bitstream.decode_kernels import SEED
from ulcx_torch.bitstream.fast_decode import bytes_to_nybbles, decode_block_fast  # noqa: F401
from ulcx_torch.codec.transform_batched import block_imdct_batched
from ulcx_torch.utils.config import CodecConfig, check_decode_supported


class DecoderCarry(NamedTuple):
    """State carried block to block, with a leading [B]."""

    lap: torch.Tensor           # [B, C, N/2] f32
    prev_last_ss: torch.Tensor  # [B] int32
    rng: torch.Tensor           # [B] int32, the u32 noise-RNG state's bits

    @staticmethod
    def init(cfg: CodecConfig, batch: int, device="cuda"):
        return DecoderCarry(
            lap=torch.zeros(batch, cfg.n_chan, cfg.block_size // 2, dtype=torch.float32,
                            device=device),
            prev_last_ss=torch.zeros(batch, dtype=torch.int32, device=device),
            rng=torch.full((batch,), SEED, dtype=torch.int32, device=device),
        )


def inverse_ms(block: torch.Tensor) -> torch.Tensor:
    """Undo pairwise M/S over the channel axis (-2): (m, s) -> (m+s, m-s);
    an odd last channel passes through (reference :280-289)."""
    c = block.shape[-2]
    if c < 2:
        return block
    m, s = block[..., 0 : c - 1 : 2, :], block[..., 1:c:2, :]
    out = torch.stack([m + s, m - s], dim=-2).reshape(block.shape[:-2] + (2 * (c // 2), -1))
    return torch.cat([out, block[..., 2 * (c // 2) :, :]], dim=-2)


def decode_stream_batched(streams: torch.Tensor, n_blocks: int, window_bytes: int,
                          cfg: CodecConfig):
    """Decode ``n_blocks`` blocks of each stream from the start.

    streams [B, S] uint8, each padded so that every block's window of
    ``window_bytes`` lies inside it (a start past S - window_bytes is
    clamped there, as lax.dynamic_slice does). Returns (pcm
    [B, n_blocks, C, N] f32, bits [B, n_blocks] i32, corrupt
    [B, n_blocks] bool)."""
    check_decode_supported(cfg)
    b, s_len = streams.shape
    if window_bytes > s_len:
        raise ValueError(f"window of {window_bytes} bytes exceeds the {s_len}-byte streams")
    dev = streams.device
    carry = DecoderCarry.init(cfg, b, dev)
    lap, prev_ss, seed = carry
    offset = torch.zeros(b, dtype=torch.int64, device=dev)
    span = torch.arange(window_bytes, device=dev)
    pcms, bits_all, corrupt_all = [], [], []
    for _ in range(n_blocks):
        start = torch.clamp(offset, max=s_len - window_bytes)
        windows = torch.gather(streams, 1, start[:, None] + span)
        coefs, wc, bits, corrupt, seed = decode_block_fast(windows, seed, cfg)
        pcm, lap, prev_ss = block_imdct_batched(coefs, wc, lap, prev_ss, cfg)
        pcms.append(inverse_ms(pcm))
        bits_all.append(bits)
        corrupt_all.append(corrupt)
        offset = offset + (bits + 7) // 8
    return torch.stack(pcms, 1), torch.stack(bits_all, 1), torch.stack(corrupt_all, 1)
