"""Prefix sums, and first-order recurrences as matrix products (port of
``ulcx.ops.scanutil``).

The reference's transient detector is built from exponential-moving-
average smears (reference libulc/ulcEncoder_WindowControl.c:72-134):
x[n] = r*x[n-1] + (1-r)*v[n]. With a constant rate that is a linear
filter, evaluated here as one float32 Toeplitz matmul (or per-chunk
matmuls plus a carry closure for long blocks).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def cumsum_f32(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """f32 prefix sums accumulated in f64: the same values on every
    device (a CUDA f32 scan and a CPU scan associate differently)."""
    return torch.cumsum(x.to(torch.float64), dim=dim).to(torch.float32)


@lru_cache(maxsize=64)
def _ema_matrix(length: int, rate: float) -> np.ndarray:
    """Lower-triangular Toeplitz kernel of the EMA as a linear filter:
    L[i, j] = (1-r) * r^(i-j) for j <= i (float64 powers, f32 cast)."""
    i = np.arange(length)
    d = i[:, None] - i[None, :]
    with np.errstate(over="ignore", under="ignore"):
        mat = (1.0 - rate) * np.power(float(rate), np.maximum(d, 0).astype(np.float64))
    mat = np.where(d >= 0, mat, 0.0)
    return mat.astype(np.float32)


def _ema_init_weights(length: int, rate: float) -> np.ndarray:
    return np.power(float(rate), np.arange(1, length + 1, dtype=np.float64)).astype(
        np.float32
    )


@lru_cache(maxsize=64)
def _ema_consts(length: int, rate: float, device: torch.device):
    """(L^T, init weights) on ``device``, built once per shape."""
    mat_t = torch.from_numpy(_ema_matrix(length, rate).T.copy()).to(device)
    w = torch.from_numpy(_ema_init_weights(length, rate)).to(device)
    return mat_t, w


def ema_matmul(v: torch.Tensor, rate: float, init, reverse: bool = False):
    """EMA along the last axis as one f32 matmul; ``init`` is x[-1] and
    broadcasts against v without its last axis."""
    n = v.shape[-1]
    if reverse:
        v = v.flip(-1)
    mat_t, w = _ema_consts(n, float(rate), v.device)
    init = torch.as_tensor(init, dtype=v.dtype, device=v.device)
    out = v @ mat_t + init[..., None] * w
    if reverse:
        out = out.flip(-1)
    return out


def ema_matmul_chunked(v: torch.Tensor, rate: float, init, reverse: bool = False,
                       chunk: int = 1024):
    """EMA as per-chunk Toeplitz matmuls plus an exact cross-chunk carry.

    x[jK+i] = local[j, i] + r^(i+1) * c_j, where ``local`` is the K-point
    EMA of chunk j from a zero state and the boundary values obey
    c_{j+1} = local[j, K-1] + r^K * c_j, closed with one [J, J] matmul.
    Same result as ``ema_matmul`` up to float association."""
    n = v.shape[-1]
    if n <= chunk:
        return ema_matmul(v, rate, init, reverse=reverse)
    assert n % chunk == 0, (n, chunk)
    j_chunks, k = n // chunk, chunk
    if reverse:
        v = v.flip(-1)
    r = float(rate)
    mat_t, w = _ema_consts(k, r, v.device)
    local = v.reshape(v.shape[:-1] + (j_chunks, k)) @ mat_t  # [..., J, K]

    e = local[..., : j_chunks - 1, -1]  # e_0 .. e_{J-2}
    jj = np.arange(j_chunks)
    with np.errstate(over="ignore", under="ignore"):
        tri = np.power(r, (k * (jj[:, None] - 1 - jj[None, :])).astype(np.float64))
    tri = np.where(jj[:, None] - 1 - jj[None, :] >= 0, tri, 0.0)[:, : j_chunks - 1]
    tri_t = torch.from_numpy(tri.astype(np.float32).T.copy()).to(v.device)
    pw = torch.from_numpy(np.power(r, (k * jj).astype(np.float64)).astype(np.float32))
    init = torch.as_tensor(init, dtype=v.dtype, device=v.device)
    c = e @ tri_t + init[..., None] * pw.to(v.device)  # [..., J]
    out = (local + c[..., None] * w).reshape(v.shape)
    if reverse:
        out = out.flip(-1)
    return out


def ema(v: torch.Tensor, rate, init, axis: int = -1, reverse: bool = False) -> torch.Tensor:
    """Run x[n] = rate*x[n-1] + (1-rate)*v[n] along ``axis``.

    Returns the post-update envelope at every position (v's shape).
    ``rate`` is a float or a tensor that broadcasts against v; ``init``
    is x[-1] and broadcasts against v with ``axis`` removed. The pairs
    (a, b) = (rate, (1-rate)*v), combined as (a1*a2, b1*a2 + b2), are
    scanned by doubling: ceil(log2 n) shifted combines, on any device."""
    axis = axis % v.ndim
    r = torch.as_tensor(rate, dtype=v.dtype, device=v.device)
    a = torch.broadcast_to(r, v.shape).movedim(axis, -1)
    b = ((1 - r) * v).movedim(axis, -1)
    if reverse:
        a, b = a.flip(-1), b.flip(-1)
    n, d = a.shape[-1], 1
    while d < n:
        b = torch.cat([b[..., :d], b[..., :-d] * a[..., d:] + b[..., d:]], dim=-1)
        a = torch.cat([a[..., :d], a[..., :-d] * a[..., d:]], dim=-1)
        d *= 2
    if reverse:
        a, b = a.flip(-1), b.flip(-1)
    init = torch.as_tensor(init, dtype=v.dtype, device=v.device)
    if init.ndim:
        init = init.unsqueeze(-1)
    return (b + a * init).movedim(-1, axis)
