"""Test signals made on the device from a seed.

The signal model of the JAX package's throughput bench (``bench.py``'s
``make_corpus``), rewritten in PyTorch so that it is drawn on the card
from ``--seed`` in a few large calls: per stream a stack of 3 tones
(60 Hz-9 kHz, amplitudes 0.02-0.3 halving tone by tone, a phase per
channel), a slow amplitude modulation (0.3-4 Hz, depth 0.4), a noise
floor at 0.01, and in 40 % of the streams (exactly int(0.4 B) of each
chunk of streams, as ``make_corpus`` chose them) 1-3 exponentially
decaying noise bursts (N/16 to N/2 samples, amplitude 0.5) that drive
window switching; clipped to [-1, 1].
"""

from __future__ import annotations

import math

import torch


CHUNK = 1024  # streams drawn at a time, which bounds the temporaries


def make_corpus(gen: torch.Generator, b: int, t: int, c: int, n: int, rate_hz: int,
                device) -> torch.Tensor:
    """[B, T, C, N] float32 PCM on ``device``, drawn from ``gen`` (a
    generator on that device), CHUNK streams at a time."""
    out = torch.empty(b, t, c, n, device=device)
    for s in range(0, b, CHUNK):
        k = min(CHUNK, b - s)
        out[s:s + k] = _streams(gen, k, t * n, c, n, rate_hz, device).reshape(
            k, c, t, n).permute(0, 2, 1, 3)
    return out


def _streams(gen, b: int, total: int, c: int, n: int, rate_hz: int, device) -> torch.Tensor:
    """[B, C, total] of the model above."""

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, device=device)

    tt = torch.arange(total, device=device, dtype=torch.float64) / rate_hz
    x = torch.zeros(b, c, total, device=device)
    for k in range(3):
        f = uniform(60.0, 9000.0, b, 1, 1).double()
        a = uniform(0.02, 0.3, b, 1, 1) * 0.5 ** k
        ph = uniform(0.0, 2 * math.pi, b, c, 1).double()
        # the phase in float64, wrapped, so that long pools keep their pitch
        arg = torch.remainder(2 * math.pi * f * tt + ph, 2 * math.pi).float()
        x += a * torch.sin(arg)
    fm = uniform(0.3, 4.0, b, 1, 1).double()
    x *= 0.6 + 0.4 * torch.sin(torch.remainder(2 * math.pi * fm * tt, 2 * math.pi)).float()
    x += 0.01 * torch.randn(b, c, total, generator=gen, device=device)

    # bursts: in int(0.4 B) streams, as many with 1, 2 and 3 bursts, at
    # positions in [0, T*N - N); which streams, from the seed
    order = torch.randperm(b, generator=gen, device=device)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(b, device=device)
    has = rank < int(0.4 * b)
    count = 1 + rank % 3
    j = torch.arange(total, device=device)
    for k in range(3):
        live = has & (count > k)
        pos = torch.randint(0, max(total - n, 1), (b, 1), generator=gen, device=device)
        dur = torch.randint(n // 16, n // 2, (b, 1), generator=gen, device=device)
        rel = j[None, :] - pos
        env = torch.exp(-rel.clamp(min=0).float() / (0.12 * dur.float()))
        inside = (rel >= 0) & (rel < dur) & live[:, None]
        burst = torch.randn(b, total, generator=gen, device=device) * torch.where(inside, env, 0.0)
        x += 0.5 * burst[:, None, :]
    return x.clamp_(-1.0, 1.0)
