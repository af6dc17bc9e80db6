"""Kernel-backed batched block decode (port of ``ulcx.bitstream.fast_decode``).

Per block, for a batch of streams:
  byte windows -> nybbles -> [FSM kernel, placing mode] expansion flags
  at record starts -> [RNG-expand kernel] coefficients.

``decode_block_fast`` runs the state machine in its placing mode
(``decode_kernels.fsm_place``): the kernel writes each record's
expansion word at its start position, so no record plane and no scatter
pass between the two kernels. ulcx keeps that placement outside its
kernel as a one-hot matmul (a Mosaic kernel cannot scatter); here it is
part of the walk. ``fsm_records`` and ``records_to_flags`` are ulcx's
two-step API: the kernel's record mode (``decode_kernels.fsm``), and
the placement as one scatter into a zeroed plane
(``decode_kernels.place_records``, also the placing mode's plain
version). ``bitstream.decode`` runs the record mode for ulcx's
single-block decoder.

The public functions keep ulcx's signatures and [B, ...] layouts; the
kernels read and write token- and position-major planes ([T, B],
[P, B]), which ``decode_block_fast`` passes from one to the next
without a transpose.

CPU tests (from the repo root):
    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_decode_kernels.py tests/test_torch_decode.py -q
On a card: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import torch

from ulcx_torch.bitstream import decode_kernels as dk
from ulcx_torch.utils.config import CodecConfig
from ulcx_torch.utils.profiling import span

_I32 = torch.int32


def bytes_to_nybbles(by: torch.Tensor) -> torch.Tensor:
    """uint8 [..., W] -> int32 nybbles [..., 2W], low nybble first."""
    return torch.stack([by & 0xF, by >> 4], dim=-1).reshape(by.shape[:-1] + (-1,)).to(_I32)


def _header_and_tokens(windows: torch.Tensor):
    """windows [B, W] uint8 -> (wc [B], hdr [B], tokens [T, B]) i32 with
    T = 2W - 2 nybbles after the 1- or 2-nybble header. With a 1-nybble
    header the window's last nybble is not read."""
    w_bytes = windows.shape[1]
    nyb = bytes_to_nybbles(windows).T  # [2W, B]
    wc0 = nyb[0]
    has2 = (wc0 & 0x8) != 0
    wc = torch.where(has2, wc0 | (nyb[1] << 4), wc0 | (1 << 4))
    hdr = torch.where(has2, 2, 1).to(_I32)
    t_len = 2 * w_bytes - 2
    tokens = torch.where(has2[None], nyb[2 : t_len + 2], nyb[1 : t_len + 1]).contiguous()
    return wc, hdr, tokens


def walks(cfg: CodecConfig) -> dk.Walks:
    """The walks ``cfg`` asks for: the kernels (whose wrappers run the
    plain versions on CPU tensors and launch the kernels on CUDA ones),
    or with ``use_pallas="off"`` the plain versions wherever the tensors
    lie, launching no kernel."""
    return walks_for(cfg.use_pallas)


def walks_for(use_pallas: str) -> dk.Walks:
    """``walks`` from the one setting it reads."""
    return dk.PLAIN_WALKS if use_pallas == "off" else dk.KERNEL_WALKS


def fsm_records(windows: torch.Tensor, cfg: CodecConfig):
    """FSM pass only: windows [B, W] uint8 at block starts ->
    (rec [B, R], code [B, R], wc [B], hdr [B], consumed [B],
    corrupt [B]), all i32, R = 2W - 2."""
    wc, hdr, tokens = _header_and_tokens(windows)
    rec, code, consumed, corrupt = walks(cfg).fsm(wc, tokens, cfg.block_size * cfg.n_chan,
                                                  cfg.block_size)
    return rec.T.contiguous(), code.T.contiguous(), wc, hdr, consumed, corrupt


def records_to_flags(rec: torch.Tensor, code: torch.Tensor, p_tot: int) -> torch.Tensor:
    """rec, code [B, R] from ``fsm_records`` -> flags [B, p_tot] i32."""
    return dk.place_records(rec.T, code.T, p_tot).T.contiguous()


def expand_coefs(flags: torch.Tensor, rng_state: torch.Tensor, p_tot: int):
    """RNG replay, record fill and coefficient assembly. flags [B, p_tot]
    from ``records_to_flags``; rng_state [B] i32 (u32 bits). Returns
    (coefs [B, p_tot] f32, new rng state [B])."""
    if flags.shape[1] != p_tot:
        raise ValueError(f"flags have {flags.shape[1]} positions, expected {p_tot}")
    coef, seed = dk.rng_expand(flags.T.contiguous(), rng_state)
    return coef.T.contiguous(), seed


def draw_counts(flags: torch.Tensor) -> torch.Tensor:
    """flags [B, P] from ``records_to_flags`` (or the placing FSM's,
    transposed) -> [B] int64: each stream's RNG draw positions, exactly
    as the RNG walk latches them (a draw record's region runs to the
    next record start, the last one's to the plane's end, which is how a
    corrupt or truncated block behaves too). The RNG-expand kernel steps
    the state once per draw position, so its new state is the old one
    jumped this many steps (``ops.rngjump.jump``)."""
    return (dk.rng_flags(flags.T) & 1).sum(0)


def decode_block_fast(windows: torch.Tensor, rng_state: torch.Tensor, cfg: CodecConfig):
    """windows [B, W] uint8 at block starts; rng_state [B] i32 (u32
    bits). Returns (coefs [B, C, N], window_ctrl [B], bits [B],
    corrupt [B] bool, new rng state [B]); a corrupt block's
    coefficients are 0."""
    with span("ulcx.decode.tokens"):
        tokens = _header_and_tokens(windows)
    return _decode_tokens(*tokens, rng_state, cfg)


def _decode_tokens(wc, hdr, tokens, rng_state, cfg: CodecConfig):
    """``decode_block_fast`` from ``_header_and_tokens``'s output on:
    the placing FSM, then RNG-expand."""
    n, c = cfg.block_size, cfg.n_chan
    w = walks(cfg)
    with span("ulcx.decode.fsm_place"):
        flags, consumed, corrupt = w.fsm_place(wc, tokens, n * c, n)
        bits = 4 * (hdr + consumed)
    with span("ulcx.decode.expand"):
        coef, new_seed = w.rng_expand(flags, rng_state)
        bad = corrupt == 1
        coefs = torch.where(bad[None], 0.0, coef).T.contiguous().reshape(-1, c, n)
    return coefs, wc, bits, bad, new_seed
