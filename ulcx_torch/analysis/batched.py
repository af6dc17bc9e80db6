"""Batched encoder analysis (port of ``ulcx.analysis.batched``).

Psychoacoustic and noise spectra are computed for every size class over
the whole batch and each coefficient takes the class its stream's
pattern uses, the same scheme as ``codec.transform_batched``.
``analyze_block_batched`` is one block step; ``analyze_stream_batched``
analyses T blocks at once, looping over blocks for window control only.
"""

from __future__ import annotations

import numpy as np
import torch

from ulcx_torch.analysis.block import (
    _INV_LOG2E,
    _NEG_LOG4,
    AnalyzedBlock,
    EncoderCarry,
    ms_transform,
)
from ulcx_torch.analysis.psy import masking_curve, noise_log_spectrum
from ulcx_torch.analysis.window_control import get_window_ctrl
from ulcx_torch.codec.transform import first_overlap, last_subblock_size
from ulcx_torch.codec.transform_batched import block_mdct_mdst_batched, device_tables, select_class
from ulcx_torch.ops.fastlog import fast_log
from ulcx_torch.utils.config import COEF_EPS, CodecConfig
from ulcx_torch.utils.profiling import span

_HALF_EPS = float(np.float32(0.5 * COEF_EPS))


def _psy_noise_batched(mdct, mdst, window_ctrl, cfg: CodecConfig):
    """Per-class psy/noise, selected per coefficient. mdct/mdst
    [B, C, N] -> (masking per coefficient [B, N], noise pairs [B, C, N])."""
    with span("ulcx.encode.analysis.psy_noise"):
        n = cfg.block_size
        b, c, _ = mdct.shape
        abs2 = mdct * mdct + mdst * mdst
        lines = abs2[..., 0::2] + abs2[..., 1::2]  # [B, C, N/2]
        lines_tot = torch.sum(lines, dim=1)  # [B, N/2]
        cls_coef = device_tables(n, mdct.device)["cls_coef"][(window_ctrl >> 4).long()]

        if cfg.use_psychoacoustics:
            mask_cls = []
            for cls in range(4):
                npos, m = 1 << cls, (n >> cls) // 2
                mk = masking_curve(lines_tot.reshape(b, npos, m), m, cfg.rate_hz)
                # coefficient k of a class maps to line k//2 of its layout
                mask_cls.append(torch.repeat_interleave(mk.reshape(b, n // 2), 2, dim=-1))
            mask_coef = select_class(mask_cls, cls_coef)
        else:
            mask_coef = torch.zeros(b, n, dtype=torch.float32, device=mdct.device)
        if cfg.use_noise_coding:
            noise_cls = []
            for cls in range(4):
                npos, m = 1 << cls, (n >> cls) // 2
                nz = noise_log_spectrum(lines.reshape(b, c, npos, m), m, cfg.rate_hz)
                noise_cls.append(nz.reshape(b, c, n))
            noise = select_class(noise_cls, cls_coef)
        else:
            noise = torch.zeros_like(mdct)
        return mask_coef, noise


def _analyze_core(samples, window_ctrl, prev_last_ss, next_ov, cfg: CodecConfig) -> AnalyzedBlock:
    """Non-recurrent analysis of a flat batch: samples [B, C, 2N]
    (prev || new pairs), window_ctrl/prev_last_ss/next_ov [B]."""
    n = cfg.block_size
    mdct, mdst = block_mdct_mdst_batched(samples, window_ctrl, prev_last_ss, next_ov, cfg)
    mask_coef, noise = _psy_noise_batched(mdct, mdst, window_ctrl, cfg)

    re2 = mdct * mdct
    tiny = torch.abs(mdct) < _HALF_EPS
    val_np = torch.where(tiny, torch.full_like(re2, -torch.inf), fast_log(re2))
    if cfg.use_psychoacoustics:
        chan = torch.arange(cfg.n_chan, device=mdct.device)
        chan_pen = _NEG_LOG4 * (chan & 1).to(torch.float32)
        importance = 2.0 * val_np + mask_coef[:, None, :] + chan_pen[None, :, None]
    else:
        importance = val_np

    csum = torch.sum(re2, dim=(1, 2))
    cw = torch.sum(torch.abs(mdct), dim=(1, 2))
    scale = float(np.float32(_INV_LOG2E) * np.float32(int(np.log2(n))))
    ratio = torch.clamp(cw * cw / torch.clamp(csum, min=1e-38), min=1e-38)
    complexity = torch.where(
        csum > 0,
        torch.clamp(torch.log(ratio) / scale, 0.0, 1.0),
        torch.zeros_like(csum),
    )
    n_nz = torch.sum(~tiny, dim=(1, 2)).to(torch.int32)
    return AnalyzedBlock(
        window_ctrl=window_ctrl,
        mdct=mdct,
        noise=noise,
        importance=importance.to(torch.float32),
        complexity=complexity.to(torch.float32),
        n_nz=n_nz,
    )


def analyze_stream_batched(carry: EncoderCarry, blocks: torch.Tensor, cfg: CodecConfig):
    """Whole-chunk analysis: blocks [B, T, C, N] -> (new carry,
    AnalyzedBlock with leading [B*T], b-major).

    Only window control is recurrent across blocks (the transient
    filter's EMAs and the one-block lookahead): it loops over T on small
    state. The transforms, psy, noise and importance then run once over
    the flat batch [B*T]."""
    with span("ulcx.encode.analysis"):
        n = cfg.block_size
        b, t = blocks.shape[0], blocks.shape[1]

        new_ms = ms_transform(blocks.to(torch.float32))  # [B, T, C, N]
        prevs = torch.cat([carry.sample_prev[:, None], new_ms[:, :-1]], dim=1)
        pairs = torch.cat([prevs, new_ms], dim=-1)  # [B, T, C, 2N]

        tstate = carry.transient
        wcs = [carry.next_window_ctrl]
        for j in range(t):
            next_wc, tstate = get_window_ctrl(pairs[:, j], tstate, cfg)
            wcs.append(next_wc)
        wcs_full = torch.stack(wcs, dim=1)  # [B, T+1]: block j is coded with column j

        wc_t = wcs_full[:, :t]
        next_ov_t = first_overlap(wcs_full[:, 1:], n)
        last_ss_all = last_subblock_size(wc_t, n)  # [B, T]
        prev_ss_t = torch.cat([carry.prev_last_ss[:, None], last_ss_all[:, : t - 1]], dim=1)

        blk = _analyze_core(
            pairs.reshape(b * t, cfg.n_chan, 2 * n),
            wc_t.reshape(b * t),
            prev_ss_t.reshape(b * t),
            next_ov_t.reshape(b * t),
            cfg,
        )
        new_carry = EncoderCarry(
            sample_prev=new_ms[:, -1].contiguous(),
            transient=tstate,
            next_window_ctrl=wcs_full[:, t],
            prev_last_ss=last_ss_all[:, -1],
        )
        return new_carry, blk


def analyze_block_batched(carry: EncoderCarry, new_blocks: torch.Tensor, cfg: CodecConfig):
    """One block step for a batch of streams: new_blocks [B, C, N]
    deinterleaved PCM. Returns (new carry, AnalyzedBlock)."""
    with span("ulcx.encode.analysis"):
        n = cfg.block_size
        new_ms = ms_transform(new_blocks.to(torch.float32))
        samples = torch.cat([carry.sample_prev, new_ms], dim=-1)  # [B, C, 2N]

        window_ctrl = carry.next_window_ctrl
        next_wc, tstate = get_window_ctrl(samples, carry.transient, cfg)
        blk = _analyze_core(samples, window_ctrl, carry.prev_last_ss, first_overlap(next_wc, n), cfg)
        new_carry = EncoderCarry(
            sample_prev=new_ms,
            transient=tstate,
            next_window_ctrl=next_wc,
            prev_last_ss=last_subblock_size(window_ctrl, n),
        )
        return new_carry, blk
