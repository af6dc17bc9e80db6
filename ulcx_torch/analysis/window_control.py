"""Transient detection and window control, batched over streams.

Port of ``ulcx.analysis.window_control`` (reference
libulc/ulcEncoder_WindowControl.c) with the stream batch written out:

1. Two 3-tap filters (HP ``-z^-1 + 2 - z``, BP ``-z^-1 + z``) over all
   channels of the M/S'd buffer, lag BlockSize/2, energies summed over
   channels (reference :31-70).
2. Forward then backward EMA smears; the 'error' energy is
   ``(dHP*EnvBP)^2 + (dBP*EnvHP)^2`` (reference :72-104).
3. A block-rate EMA integrates the error into 8 segment sums, carried
   across blocks in a 16-entry buffer (reference :107-134).
4. A window-size search of at most 4 static iterations, with masked
   per-stream updates, then the overlap scale (reference :140-239).
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import torch

from ulcx_torch.ops.scanutil import cumsum_f32, ema_matmul, ema_matmul_chunked
from ulcx_torch.utils.config import CodecConfig

_RATE_HP_FWD = float.fromhex("0x1.CC845Cp6")   # -1.0 dB/ms
_RATE_BP_FWD = float.fromhex("0x1.596344p8")   # -3.0 dB/ms
_RATE_HP_BWD = float.fromhex("0x1.CC845Cp7")   # -2.0 dB/ms
_RATE_BP_BWD = float.fromhex("0x1.596344p8")   # -3.0 dB/ms
_RATE_BLOCK = float.fromhex("0x1.1AF110p-6")   # -0.00015 dB/ms * BlockSize
_LOG2 = float.fromhex("0x1.62E430p-1")
_INV_LOG2 = float.fromhex("0x1.715476p0")


class TransientState(NamedTuple):
    """Carried across blocks (reference TransientFilter[3] + TransientBuffer);
    every leaf has a leading stream axis [B]."""

    env_hp: torch.Tensor      # [B] f32
    env_bp: torch.Tensor      # [B] f32
    env_block: torch.Tensor   # [B] f32
    seg_sum: torch.Tensor     # [B, 16] f32: L half then R half
    seg_w: torch.Tensor       # [B, 16] f32

    @staticmethod
    def init(batch: int, device="cuda"):
        z = torch.zeros(batch, dtype=torch.float32, device=device)
        z16 = torch.zeros(batch, 16, dtype=torch.float32, device=device)
        return TransientState(z, z.clone(), z.clone(), z16, z16.clone())


def _transient_filtering(samples: torch.Tensor, st: TransientState, cfg: CodecConfig):
    """samples [B, C, 2N] (prev block || new block, already M/S) -> new
    TransientState with fresh R-half segment sums."""
    n = cfg.block_size
    rate_hz = cfg.rate_hz
    b = samples.shape[0]

    q = samples[..., n // 2 - 1 : n // 2 - 1 + n + 2]  # [B, C, N+2]
    t0, t1, t2 = q[..., :-2], q[..., 1:-1], q[..., 2:]
    hp = torch.sum((-t0 + 2 * t1 - t2) ** 2, dim=-2)  # [B, N]
    bp = torch.sum((-t0 + t2) ** 2, dim=-2)

    ema_f = ema_matmul if n <= 2048 else partial(ema_matmul_chunked, chunk=1024)

    env_hp = ema_f(torch.sqrt(hp), math.exp(-_RATE_HP_FWD / rate_hz), st.env_hp)
    env_bp = ema_f(torch.sqrt(bp), math.exp(-_RATE_BP_FWD / rate_hz), st.env_bp)

    # backward smear; d uses the pre-update envelope, the cross products
    # the post-update one (reference :96-104)
    pre_hp = ema_f(env_hp, math.exp(-_RATE_HP_BWD / rate_hz), env_hp[..., -1], reverse=True)
    pre_bp = ema_f(env_bp, math.exp(-_RATE_BP_BWD / rate_hz), env_bp[..., -1], reverse=True)
    before_hp = torch.cat([pre_hp[..., 1:], env_hp[..., -1:]], dim=-1)
    before_bp = torch.cat([pre_bp[..., 1:], env_bp[..., -1:]], dim=-1)
    d_hp = env_hp - before_hp
    d_bp = env_bp - before_bp
    err = (d_hp * pre_bp) ** 2 + (d_bp * pre_hp) ** 2

    r_blk = math.exp(-_RATE_BLOCK * cfg.block_size / rate_hz)
    em = ema_f(err, r_blk, st.env_block)
    seg_new = torch.sum(em.reshape(b, 8, n // 8), dim=-1)

    return TransientState(
        env_hp=env_hp[..., -1],
        env_bp=env_bp[..., -1],
        env_block=em[..., -1],
        seg_sum=torch.cat([st.seg_sum[:, 8:], seg_new], dim=-1),
        seg_w=torch.cat([st.seg_w[:, 8:], torch.full_like(seg_new, float(n // 8))], dim=-1),
    )


def _log_ratio(s: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.where(
        s > 0,
        torch.log(torch.clamp(s, min=1e-38) / torch.clamp(w, min=1e-38)),
        torch.full_like(s, -100.0),
    )


def _segment_ratios(st: TransientState, n_seg: int, seg_size: int):
    """(max_ratio [B], argmax segment [B]) for one search iteration."""
    zero = torch.zeros_like(st.seg_sum[:, :1])
    csum = torch.cat([zero, cumsum_f32(st.seg_sum)], dim=-1)  # [B, 17]
    cw = torch.cat([zero, cumsum_f32(st.seg_w)], dim=-1)
    starts = 8 + torch.arange(n_seg, device=csum.device) * seg_size
    r_np = _log_ratio(
        csum[:, starts + seg_size] - csum[:, starts], cw[:, starts + seg_size] - cw[:, starts]
    )
    l_np = _log_ratio(
        csum[:, starts] - csum[:, starts - seg_size], cw[:, starts] - cw[:, starts - seg_size]
    )
    ratio = torch.abs(r_np - l_np)
    max_ratio, max_seg = torch.max(ratio, dim=-1)  # first max, like the C scan
    return max_ratio, max_seg.to(torch.int32)


def get_window_ctrl(samples: torch.Tensor, st: TransientState, cfg: CodecConfig):
    """Window control for each stream's *next* block (reference
    ULCi_GetWindowCtrl). samples [B, C, 2N] M/S'd. Returns (window_ctrl
    [B] int32, new TransientState)."""
    st = _transient_filtering(samples, st, cfg)

    n = cfg.block_size
    b = samples.shape[0]
    dev = samples.device
    max_decim = cfg.max_decimation
    log2_sub = int(math.log2(n // max_decim))
    n_segments = max_decim
    seg_size = 8 // max_decim
    if log2_sub < 6:
        shift = 6 - log2_sub
        n_segments >>= shift
        seg_size <<= shift
        log2_sub = 6

    decim = torch.ones(b, dtype=torch.int32, device=dev)
    trans_ratio = torch.zeros(b, dtype=torch.float32, device=dev)
    final_log2 = torch.full((b,), log2_sub, dtype=torch.int32, device=dev)
    running = torch.ones(b, dtype=torch.bool, device=dev)
    k = 0
    while (n_segments >> k) >= 1:
        ns, sz = n_segments >> k, seg_size << k
        max_ratio, max_seg = _segment_ratios(st, ns, sz)
        accept = running & (max_ratio - trans_ratio >= _LOG2)
        final_log2 = torch.where(running, torch.full_like(final_log2, log2_sub + 1 + k), final_log2)
        decim = torch.where(accept, ns + max_seg, decim)
        trans_ratio = torch.where(accept, max_ratio, trans_ratio)
        running = accept & (ns > 1) & (trans_ratio < _LOG2)
        k += 1

    ratio_l2 = trans_ratio * _INV_LOG2
    scale = torch.where(
        ratio_l2 < 0.5,
        torch.zeros_like(decim),
        torch.where(ratio_l2 >= 6.5, torch.full_like(decim, 7), torch.round(ratio_l2).to(torch.int32)),
    )
    scale = torch.where(final_log2 - scale < 6, final_log2 - 6, scale)
    wc = scale + 0x8 * (decim != 1).to(torch.int32) + 0x10 * decim
    wc = torch.where(trans_ratio < _LOG2 / 2, torch.full_like(wc, 0x10), wc)
    return wc.to(torch.int32), st
