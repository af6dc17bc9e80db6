"""Kernel-backed batched block decode (port of ``ulcx.bitstream.fast_decode``).

Per block, for a batch of streams:
  byte windows -> nybbles -> [FSM kernel] records -> scatter at record
  starts -> [RNG-expand kernel] coefficients.

The public functions keep ulcx's signatures and [B, ...] layouts; the
kernels read and write token- and position-major planes ([T, B],
[P, B]), which ``decode_block_fast`` passes from one to the next
without a transpose. The record placement is one scatter into a zeroed
plane (starts strictly increase within a stream, so no two records
share a position); ulcx's one-hot matmul placement has no counterpart.
"""

from __future__ import annotations

import torch

from ulcx_torch.bitstream import decode_kernels as dk
from ulcx_torch.utils.config import CodecConfig

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


def _fsm_planes(windows: torch.Tensor, cfg: CodecConfig):
    """The FSM on token planes: (rec [T, B], code [T, B], wc, hdr,
    consumed, corrupt)."""
    wc, hdr, tokens = _header_and_tokens(windows)
    rec, code, consumed, corrupt = dk.fsm(wc, tokens, cfg.block_size * cfg.n_chan, cfg.block_size)
    return rec, code, wc, hdr, consumed, corrupt


def fsm_records(windows: torch.Tensor, cfg: CodecConfig):
    """FSM pass only: windows [B, W] uint8 at block starts ->
    (rec [B, R], code [B, R], wc [B], hdr [B], consumed [B],
    corrupt [B]), all i32, R = 2W - 2."""
    rec, code, wc, hdr, consumed, corrupt = _fsm_planes(windows, cfg)
    return rec.T.contiguous(), code.T.contiguous(), wc, hdr, consumed, corrupt


def _place(rec: torch.Tensor, code: torch.Tensor, p_tot: int) -> torch.Tensor:
    """Records [T, B] -> expansion flags [P, B] i32: each record's packed
    word (start | draw << 1 | coded << 2 | tail << 3 | code << 4) at its
    start position, 0 elsewhere."""
    t_len, b = rec.shape
    rtype = (rec >> 15) & 0x7
    emit = rtype != dk.REC_NONE
    draw = (rtype == dk.REC_NOISE) | (rtype == dk.REC_TAIL)
    meta = torch.where(
        emit,
        1 | (draw.to(_I32) << 1) | ((rtype == dk.REC_COEF).to(_I32) << 2)
        | ((rtype == dk.REC_TAIL).to(_I32) << 3) | (code << 4),
        0,
    ).to(_I32)
    # tokens without a record write 0 into a drop row at P
    row = torch.where(emit, rec & 0x7FFF, p_tot).long()
    flat = torch.zeros(((p_tot + 1) * b,), dtype=_I32, device=rec.device)
    col = torch.arange(b, device=rec.device)
    flat.scatter_(0, (row * b + col).reshape(-1), meta.reshape(-1))
    return flat[: p_tot * b].reshape(p_tot, b)


def records_to_flags(rec: torch.Tensor, code: torch.Tensor, p_tot: int) -> torch.Tensor:
    """rec, code [B, R] from ``fsm_records`` -> flags [B, p_tot] i32."""
    return _place(rec.T, code.T, p_tot).T.contiguous()


def expand_coefs(flags: torch.Tensor, rng_state: torch.Tensor, p_tot: int):
    """RNG replay, record fill and coefficient assembly. flags [B, p_tot]
    from ``records_to_flags``; rng_state [B] i32 (u32 bits). Returns
    (coefs [B, p_tot] f32, new rng state [B])."""
    if flags.shape[1] != p_tot:
        raise ValueError(f"flags have {flags.shape[1]} positions, expected {p_tot}")
    coef, seed = dk.rng_expand(flags.T.contiguous(), rng_state)
    return coef.T.contiguous(), seed


def decode_block_fast(windows: torch.Tensor, rng_state: torch.Tensor, cfg: CodecConfig):
    """windows [B, W] uint8 at block starts; rng_state [B] i32 (u32
    bits). Returns (coefs [B, C, N], window_ctrl [B], bits [B],
    corrupt [B] bool, new rng state [B]); a corrupt block's
    coefficients are 0."""
    n, c = cfg.block_size, cfg.n_chan
    rec, code, wc, hdr, consumed, corrupt = _fsm_planes(windows, cfg)
    coef, new_seed = dk.rng_expand(_place(rec, code, n * c), rng_state)
    bad = corrupt == 1
    coefs = torch.where(bad[None], 0.0, coef).T.contiguous().reshape(-1, c, n)
    return coefs, wc, 4 * (hdr + consumed), bad, new_seed
