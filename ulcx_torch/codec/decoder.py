"""Batched stream decoder: bitstream -> coefficients -> IMDCT -> PCM.

Port of the kernel path of ``ulcx.codec.decoder`` (reference
ULC_DecodeBlock, ulcDecoder.c:198-302): per block, the FSM and
RNG-expand kernels give the coefficients, the batched inverse transform
laps them with the previous block, and the pairwise M/S is undone. The
block axis is a Python loop; each stream's byte offset advances by its
block's whole bytes and stays a tensor on the device. ``decode_stream``
decodes one stream as a batch of one, and takes and returns ``(offset,
carry)`` so that a stream continues call after call; ``decode_block``
is ulcx's single-block form (``bitstream.decode``); ``decoder_carry_from_numpy`` and
``decoder_carry_to_numpy`` move that carry to and from ``ulcx``'s.
``decode_stream_pipelined`` decodes one stream with the same interface
and results, keeping only the state machine serial: it resolves every
block's start first, then expands, transforms and laps all the blocks
at once.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ulcx_torch.bitstream.decode import decode_block_tokens, expand_records
from ulcx_torch.bitstream.decode_kernels import SEED
from ulcx_torch.bitstream.fast_decode import (  # noqa: F401
    _decode_tokens,
    _header_and_tokens,
    bytes_to_nybbles,
    decode_block_fast,
    draw_counts,
    walks,
)
from ulcx_torch.codec.transform import block_imdct
from ulcx_torch.codec.transform_batched import block_imdct_batched, last_subblock_size
from ulcx_torch.ops.rngjump import jump
from ulcx_torch.utils.config import CodecConfig
from ulcx_torch.utils.device import on_device
from ulcx_torch.utils.profiling import span


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


def decoder_carry_from_numpy(carry, device="cuda") -> DecoderCarry:
    """An ``ulcx`` DecoderCarry with numpy leaves (``lap`` f32, ``prev_last_ss``
    i32, ``rng`` u32; batched or not) -> the port's on ``device``. Fields
    are read by name; the u32 state's bits are kept, not its value."""
    rng = np.asarray(carry.rng).astype(np.uint32).view(np.int32)
    return DecoderCarry(
        lap=torch.tensor(np.asarray(carry.lap), dtype=torch.float32, device=device),
        prev_last_ss=torch.tensor(np.asarray(carry.prev_last_ss), dtype=torch.int32, device=device),
        rng=torch.tensor(rng, dtype=torch.int32, device=device),
    )


def decoder_carry_to_numpy(carry: DecoderCarry) -> DecoderCarry:
    """The port's carry -> the same structure with numpy leaves, field
    for field what ``ulcx``'s holds: ``rng`` comes back as u32."""
    return DecoderCarry(
        lap=carry.lap.detach().cpu().numpy(),
        prev_last_ss=carry.prev_last_ss.detach().cpu().numpy(),
        rng=carry.rng.detach().cpu().numpy().view(np.uint32),
    )


def _window_span(streams: torch.Tensor, window_bytes: int) -> torch.Tensor:
    """A window's byte offsets [window_bytes], once the window is checked
    to fit the streams [B, S]."""
    if window_bytes > streams.shape[1]:
        raise ValueError(f"window of {window_bytes} bytes exceeds the {streams.shape[1]}-byte "
                         "streams")
    return torch.arange(window_bytes, device=streams.device)


def _windows(streams: torch.Tensor, offset: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Each stream's window [B, W] at its byte offset [B] (``cols`` from
    ``_window_span``); a start past S - W is clamped there."""
    start = torch.clamp(offset, max=streams.shape[1] - cols.shape[0])
    return torch.gather(streams, 1, start[:, None] + cols)


def _decode_blocks(streams: torch.Tensor, n_blocks: int, window_bytes: int, cfg: CodecConfig,
                   offset: torch.Tensor, carry: DecoderCarry):
    """The block loop: ``n_blocks`` blocks of streams [B, S] from byte
    ``offset`` [B] int64 and ``carry``. Returns (pcm [B, n_blocks, C, N],
    bits, corrupt [B, n_blocks], (offset, carry) after the last block)."""
    lap, prev_ss, seed = carry
    with span("ulcx.decode"):
        cols = _window_span(streams, window_bytes)
        pcms, bits_all, corrupt_all = [], [], []
        for _ in range(n_blocks):
            with span("ulcx.decode.tokens"):
                tokens = _header_and_tokens(_windows(streams, offset, cols))
            coefs, wc, bits, corrupt, seed = _decode_tokens(*tokens, seed, cfg)
            pcm, lap, prev_ss = block_imdct_batched(coefs, wc, lap, prev_ss, cfg)
            with span("ulcx.decode.ms"):
                pcms.append(inverse_ms(pcm))
                offset = offset + (bits + 7) // 8
            bits_all.append(bits)
            corrupt_all.append(corrupt)
        return (torch.stack(pcms, 1), torch.stack(bits_all, 1), torch.stack(corrupt_all, 1),
                (offset, DecoderCarry(lap, prev_ss, seed)))


def decode_stream_batched(streams: torch.Tensor, n_blocks: int, window_bytes: int,
                          cfg: CodecConfig):
    """Decode ``n_blocks`` blocks of each stream from the start.

    streams [B, S] uint8, each padded so that every block's window of
    ``window_bytes`` lies inside it (a start past S - window_bytes is
    clamped there, as lax.dynamic_slice does). Returns (pcm
    [B, n_blocks, C, N] f32, bits [B, n_blocks] i32, corrupt
    [B, n_blocks] bool)."""
    b, dev = streams.shape[0], streams.device
    offset = torch.zeros(b, dtype=torch.int64, device=dev)
    pcm, bits, corrupt, _ = _decode_blocks(streams, n_blocks, window_bytes, cfg, offset,
                                           DecoderCarry.init(cfg, b, dev))
    return pcm, bits, corrupt


def decode_stream(stream, n_blocks: int, window_bytes: int, cfg: CodecConfig, offset=None,
                  carry: DecoderCarry | None = None, device="cuda"):
    """Decode ``n_blocks`` blocks of one padded byte stream [S] uint8 on
    ``device``. Returns (pcm [n_blocks, C, N], bits [n_blocks], corrupt
    [n_blocks], (offset, carry)): the byte offset (a 0-d int64 tensor)
    and the carry (no batch axis) after the last block; feed them back
    in to continue the stream."""
    stream, offset, carry = _one_stream(stream, offset, carry, cfg, device)
    pcm, bits, corrupt, (offset, carry) = _decode_blocks(
        stream[None], n_blocks, window_bytes, cfg, offset, carry)
    return pcm[0], bits[0], corrupt[0], (offset[0], DecoderCarry(*(x[0] for x in carry)))


def _one_stream(stream, offset, carry, cfg: CodecConfig, device):
    """One stream's (stream on ``device``, offset [1] int64, carry with a
    batch axis of one), from the caller's stream, offset (None: 0) and
    carry (None: a stream's start)."""
    stream = on_device(stream, device)
    dev = stream.device
    if offset is None:
        offset = torch.zeros((), dtype=torch.int64, device=dev)
    offset = torch.as_tensor(offset, dtype=torch.int64).to(dev).reshape(1)
    if carry is None:
        carry = DecoderCarry.init(cfg, 1, dev)
    else:
        carry = DecoderCarry(*(x.to(dev)[None] for x in carry))
    return stream, offset, carry


def decode_stream_pipelined(stream, n_blocks: int, window_bytes: int, cfg: CodecConfig,
                            offset=None, carry: DecoderCarry | None = None, device="cuda"):
    """``decode_stream`` with only the state machine serial: the same
    interface and results (bits, corrupt flags, offset and RNG state
    exactly; PCM and lap to float rounding, the transforms summing over
    a batch of T blocks instead of one).

    A block depends on the blocks before it in three ways, and each is
    resolved ahead of the batched work (``ulcx.codec.decoder.
    decode_stream_pipelined``):
      - its start: the state machine alone walks the blocks in order
        (one placing-FSM launch a block at a batch of one, the offset a
        device tensor), which also gives every block's expansion flags;
      - its RNG state: the stream-global xorshift32 steps once per draw
        position, so the draw counts of the blocks before (exclusive
        prefix sums of ``fast_decode.draw_counts``) jump the entry state
        to each block's (``ops.rngjump.jump``); then one RNG-expand
        launch expands all T blocks, a corrupt block's coefficients 0;
      - its lap: a block's new lap depends on its own synthesis only, so
        one inverse transform from zero laps gives every lap, and a
        second, with the laps shifted by one block, the PCM; then M/S.
    Nothing synchronises with the host."""
    with span("ulcx.decode"):
        stream, offset, carry = _one_stream(stream, offset, carry, cfg, device)
        n, c = cfg.block_size, cfg.n_chan
        w = walks(cfg)
        cols = _window_span(stream[None], window_bytes)
        flags, wcs, bits, corrupt = [], [], [], []
        for _ in range(n_blocks):
            with span("ulcx.decode.tokens"):
                wc, hdr, tokens = _header_and_tokens(_windows(stream[None], offset, cols))
            with span("ulcx.decode.fsm_place"):
                fl, consumed, bad = w.fsm_place(wc, tokens, n * c, n)
                b = 4 * (hdr + consumed)
                offset = offset + (b + 7) // 8
            flags.append(fl)
            wcs.append(wc)
            bits.append(b)
            corrupt.append(bad == 1)
        with span("ulcx.decode.expand"):
            flags = torch.cat(flags, 1)  # [P, T]
            wc, bits, corrupt = torch.cat(wcs), torch.cat(bits), torch.cat(corrupt)
            draws = draw_counts(flags.T)
            seeds = jump(carry.rng.expand(n_blocks), torch.cumsum(draws, 0) - draws)
            coef, seed_after = w.rng_expand(flags, seeds)
            coefs = torch.where(corrupt[None], 0.0, coef).T.contiguous().reshape(n_blocks, c, n)

        last_ss = last_subblock_size(wc, cfg)
        prev_ss = torch.cat([carry.prev_last_ss, last_ss[:-1]])
        zero_lap = torch.zeros((n_blocks, c, n // 2), dtype=torch.float32, device=stream.device)
        _, new_lap, _ = block_imdct_batched(coefs, wc, zero_lap, prev_ss, cfg)
        pcm, _, _ = block_imdct_batched(coefs, wc, torch.cat([carry.lap, new_lap[:-1]]), prev_ss,
                                        cfg)
        carry = DecoderCarry(new_lap[-1], last_ss[-1], seed_after[-1])
        with span("ulcx.decode.ms"):
            pcm = inverse_ms(pcm)
        return pcm, bits, corrupt, (offset[0], carry)


def decode_block(window: torch.Tensor, carry: DecoderCarry, cfg: CodecConfig):
    """Decode one block from a byte window [W] uint8 that starts at the
    block's boundary (W at least the largest block's bytes), ulcx's
    form: ``bitstream.decode.decode_block_tokens`` (the record-mode
    FSM), ``expand_records`` (placement, RNG-expand), ``transform.
    block_imdct``, M/S. ``carry`` has no batch axis. Returns (pcm [C, N],
    new carry, bits consumed, corrupt), computed where ``window`` lies;
    bits, corrupt flags, coefficients and PCM are those of
    ``decode_stream`` (whose placing FSM fuses the placement)."""
    n, c = cfg.block_size, cfg.n_chan
    with span("ulcx.decode"):
        with span("ulcx.decode.tokens"):
            wc, hdr, tokens = _header_and_tokens(window[None])
        with span("ulcx.decode.fsm_place"):
            records, consumed, corrupt = decode_block_tokens(tokens[:, 0], wc[0], cfg)
        with span("ulcx.decode.expand"):
            flat, rng = expand_records(records, carry.rng, n * c, cfg.use_pallas)
            coefs = torch.where(corrupt, 0.0, flat).reshape(c, n)
        pcm, lap, last_ss = block_imdct(coefs, wc[0], carry.lap, carry.prev_last_ss, cfg)
        with span("ulcx.decode.ms"):
            pcm = inverse_ms(pcm)
        return pcm, DecoderCarry(lap, last_ss, rng), 4 * (hdr[0] + consumed), corrupt
