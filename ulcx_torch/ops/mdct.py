"""Sine windows, the MDCT/MDST folds and the IMDCT (port of ``ulcx.ops.mdct``).

Reduction (see ``ulcx.ops.mdct`` for the derivation from the
bitstream's IMDCT basis):

  forward:  u = fold(window * frame2N);  X = -(2/N) * dct4(u)

  inverse:  v = dct4(X);  y = concat(-v[N/2:], rev(v), v[:N/2])

with fold(z) = concat(-rev(z[N:3N/2]) - z[3N/2:], z[:N/2] - rev(z[N/2:N])).
"""

from __future__ import annotations

import math

import torch

from ulcx_torch.ops.dct import dct4, dct4_dst4


def rise_window(length: int, overlap: torch.Tensor) -> torch.Tensor:
    """Window halves rising around their centre: overlap [...] (integer
    tensor, a power of two or 0) -> [..., length] f32. Zero before the
    transition, a sine rise over ``overlap`` samples, one after."""
    o = overlap.to(torch.float32)[..., None]
    j = torch.arange(length, dtype=torch.float32, device=overlap.device)
    start = length / 2 - o / 2
    t = (j - start + 0.5) / o
    w = torch.sin(math.pi / 2 * torch.clamp(t, 0.0, 1.0))
    one = torch.ones_like(w)
    return torch.where(j < start, torch.zeros_like(w), torch.where(j >= start + o, one, w))


def fall_window(length: int, overlap: torch.Tensor) -> torch.Tensor:
    """Window halves falling around their centre: the rise mirrored."""
    return rise_window(length, overlap).flip(-1)


def frame_window(s: int, o_left, o_right, device=None) -> torch.Tensor:
    """Full [..., 2S] frame window: rise centred at S/2 (``o_left``),
    fall centred at 3S/2 (``o_right``); the overlaps are ints or integer
    tensors [...], the window's leading shape theirs broadcast. It lies
    on ``device``, by default an overlap tensor's device (else the CPU)."""
    if device is None:
        device = next((o.device for o in (o_left, o_right) if isinstance(o, torch.Tensor)), "cpu")
    rise = rise_window(s, torch.as_tensor(o_left, device=device))
    fall = fall_window(s, torch.as_tensor(o_right, device=device))
    rise, fall = torch.broadcast_tensors(rise, fall)
    return torch.cat([rise, fall], dim=-1)


def _quarters(z: torch.Tensor):
    s = z.shape[-1] // 2
    h = s // 2
    zc = z[..., s : s + h].flip(-1)   # rev(z[S:3S/2])
    zd = z[..., s + h :]              # z[3S/2:2S]
    za = z[..., :h]                   # z[:S/2]
    zb = z[..., h:s].flip(-1)         # rev(z[S/2:S])
    return za, zb, zc, zd


def mdct_fold(z: torch.Tensor) -> torch.Tensor:
    """[..., 2S] windowed frame -> [..., S] DCT-IV input."""
    za, zb, zc, zd = _quarters(z)
    return torch.cat([-zc - zd, za - zb], dim=-1)


def mdst_fold(z: torch.Tensor) -> torch.Tensor:
    """[..., 2S] windowed frame -> [..., S] DST-IV input."""
    za, zb, zc, zd = _quarters(z)
    return torch.cat([zc - zd, za + zb], dim=-1)


def _windowed(frame: torch.Tensor, o_left, o_right) -> torch.Tensor:
    s = frame.shape[-1] // 2
    return frame * frame_window(s, o_left, o_right, frame.device)


def mdct_mdst_frame(frame: torch.Tensor, o_left, o_right, backend: str = "matmul"):
    """MDCT and MDST of [..., 2S] raw frames, normalized by 2/S (the
    reference's encoder-side 2/SubBlockSize). ``o_left``/``o_right``
    are ints or integer tensors (a scalar, or one a row of the frames'
    leading shape). Returns (mdct, mdst), each [..., S]; the MDST's sign
    does not matter downstream (only its square is used)."""
    s = frame.shape[-1] // 2
    z = _windowed(frame, o_left, o_right)
    norm = 2.0 / s
    mc, ms = dct4_dst4(mdct_fold(z), mdst_fold(z), backend)
    return -mc * norm, -ms * norm


def mdct_frame(frame: torch.Tensor, o_left, o_right, backend: str = "matmul") -> torch.Tensor:
    """The MDCT half of ``mdct_mdst_frame``."""
    s = frame.shape[-1] // 2
    return -dct4(mdct_fold(_windowed(frame, o_left, o_right)), backend) * (2.0 / s)


def imdct_halfspec(x: torch.Tensor, backend: str = "matmul") -> torch.Tensor:
    """[..., S] coefficients -> [..., S] half-spectrum v (unnormalized);
    v determines the 2S-sample IMDCT output (``imdct_expand``)."""
    return dct4(x, backend)


def imdct_expand(v: torch.Tensor) -> torch.Tensor:
    """Half-spectrum v [..., S] -> full aliased output y [..., 2S]."""
    h = v.shape[-1] // 2
    return torch.cat([-v[..., h:], v.flip(-1), v[..., :h]], dim=-1)
