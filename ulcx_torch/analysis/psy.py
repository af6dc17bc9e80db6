"""Bark-band psychoacoustic masking and noise log-spectrum.

Port of ``ulcx.analysis.psy`` (reference libulc/ulcEncoder_Psyopt.c).
Band edges and per-line interpolation tables depend only on (line
count, sample rate) and are built once in numpy. Band sums are taken
per band over its own lines through a 0/1 [m, 25] matrix product — not
as differences of whole-spectrum prefix sums, which cancel
catastrophically for quiet bands in f32 (the reference accumulates in
double for the same reason, Psyopt.c:16-50).

Masking bands span [Bark-0.75, Bark+0.25] (reference :102-116); the
noise analysis spans [Bark, Bark+2] (reference :190-205).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ulcx_torch.ops.fastlog import fast_log
from ulcx_torch.utils.config import N_BARK_BANDS

_LOG2 = float(np.float32(float.fromhex("0x1.62E430p-1")))
_TINY = 2.0**-126


def _freq_to_line(f, nyquist, m):
    return np.float32(f) * np.float32(m) / np.float32(nyquist) - np.float32(0.5)


def _line_to_freq(line, nyquist, m):
    return (np.float32(line) + np.float32(0.5)) * np.float32(nyquist) / np.float32(m)


def _bark_to_freq(bark):
    return np.float32(600.0) * np.sinh(np.float32(bark) * np.float32(1.0 / 6.0))


def _freq_to_bark(f):
    return np.float32(6.0) * np.arcsinh(np.float32(f) * np.float32(1.0 / 600.0))


@lru_cache(maxsize=64)
def band_edges(m: int, rate_hz: int, lo_off: float, hi_off: float):
    """(beg[25], end[25]) static line indices for one pseudo-DFT size."""
    nyq = np.float32(rate_hz) * np.float32(0.5)
    beg, end = [], []
    for band in range(N_BARK_BANDS):
        fb = _bark_to_freq(np.float32(band) + np.float32(lo_off))
        fe = _bark_to_freq(np.float32(band) + np.float32(hi_off))
        lb = int(np.floor(_freq_to_line(fb, nyq, m)))
        le = int(np.ceil(_freq_to_line(fe, nyq, m)))
        beg.append(min(max(lb, 0), m - 1))
        end.append(min(max(le, 0), m))
    return np.asarray(beg, np.int32), np.asarray(end, np.int32)


@lru_cache(maxsize=64)
def line_interp_tables(m: int, rate_hz: int):
    """Static (left band [m], right band [m], frac [m]) per line."""
    nyq = np.float32(rate_hz) * np.float32(0.5)
    bark = _freq_to_bark(_line_to_freq(np.arange(m, dtype=np.float32), nyq, m))
    bidx = bark.astype(np.int32)  # truncation, like the C cast
    frac = bark - bidx.astype(np.float32)
    il = np.minimum(bidx, N_BARK_BANDS - 1)
    ir = np.where(bidx + 1 < N_BARK_BANDS, bidx + 1, il)
    return il, ir, frac.astype(np.float32)


@lru_cache(maxsize=64)
def _tables(m: int, rate_hz: int, lo_off: float, hi_off: float, device: torch.device):
    """Device copies: (band 0/1 matrix [m, 25], line count [25],
    left band [m], right band [m], frac [m])."""
    beg, end = band_edges(m, rate_hz, lo_off, hi_off)
    oh = np.zeros((m, N_BARK_BANDS), np.float32)
    for b in range(N_BARK_BANDS):
        oh[beg[b] : end[b], b] = 1.0
    il, ir, frac = line_interp_tables(m, rate_hz)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (
        dev(oh),
        dev((end - beg).astype(np.float32)),
        dev(il.astype(np.int64)),
        dev(ir.astype(np.int64)),
        dev(frac),
    )


def _forward_fill(values: torch.Tensor, valid: torch.Tensor, init: float) -> torch.Tensor:
    """Per-band forward fill along the last axis: the last valid value
    so far, else ``init``."""
    idx = torch.arange(values.shape[-1], device=values.device).expand_as(values)
    last = torch.cummax(torch.where(valid, idx, torch.full_like(idx, -1)), dim=-1).values
    got = torch.gather(values, -1, last.clamp(min=0))
    return torch.where(last >= 0, got, torch.full_like(got, init))


def _band_lerp(bark_vals: torch.Tensor, il, ir, frac) -> torch.Tensor:
    """Per-line lerp of [..., 25] band values -> [..., m]."""
    return bark_vals[..., il] * (1.0 - frac) + bark_vals[..., ir] * frac


def _band_sums(data, log_data, oh):
    """(floor, peak, peak_w) over each band's own lines."""
    s = torch.stack([log_data, log_data * data, data], dim=-2) @ oh  # [..., 3, 25]
    return s[..., 0, :], s[..., 1, :], s[..., 2, :]


def masking_curve(amp2: torch.Tensor, m: int, rate_hz: int) -> torch.Tensor:
    """Per-line masking offset (nepers) for one subblock size.
    amp2 [..., m]: pseudo-DFT line energies, all channels accumulated."""
    oh, nlines, il, ir, frac = _tables(m, rate_hz, -0.75, 0.25, amp2.device)
    log_amp = fast_log(_TINY + amp2)
    floor, peak, peak_w = _band_sums(amp2, log_amp, oh)
    valid = peak_w > 0
    safe_w = torch.where(valid, peak_w, torch.ones_like(peak_w))
    ratio = peak / safe_w - floor / torch.clamp(nlines, min=1.0) - torch.log(safe_w)
    bark_unmasked = _forward_fill(torch.where(valid, ratio, torch.zeros_like(ratio)), valid, 0.0)
    return _band_lerp(bark_unmasked, il, ir, frac)


def noise_log_spectrum(energy: torch.Tensor, m: int, rate_hz: int) -> torch.Tensor:
    """Per-channel noise-fill spectrum for one subblock size.
    energy [..., m] -> [..., 2m] interleaved {w, w*(log-level + log 2)}
    pairs (reference ULCi_CalculateNoiseLogSpectrum, Psyopt.c:236-249)."""
    oh, nlines, il, ir, frac = _tables(m, rate_hz, 0.0, 2.0, energy.device)
    log_e = fast_log(_TINY + energy)
    floor, peak, peak_w = _band_sums(energy, log_e, oh)
    nlines = torch.clamp(nlines, min=1.0)
    valid = peak_w > 0
    safe_w = torch.where(valid, peak_w, torch.ones_like(peak_w))
    scale = 1.0 / nlines
    level = 0.5 * (torch.log(safe_w * scale) + floor * scale - peak / safe_w)
    bark_noise = _forward_fill(
        torch.where(valid, level, torch.full_like(level, -100.0)), valid, -100.0
    )
    noise = _band_lerp(bark_noise, il, ir, frac)
    w = torch.exp(0.5 * noise)
    pairs = torch.stack([w, w * (noise + _LOG2)], dim=-1)
    return pairs.reshape(pairs.shape[:-2] + (2 * m,))
