"""Type-IV DCT/DST in three backends (port of ``ulcx.ops.dct``).

    dct4(x)[k] = sum_n x[n] * cos(pi/N * (n+1/2) * (k+1/2))
    dst4(x)[k] = sum_n x[n] * sin(pi/N * (n+1/2) * (k+1/2))

- ``matmul``: one [.., N] @ [N, N] product with a basis built in float64
  and cast to float32.
- ``fact``: the DCT-IV as one complex FFT of length M = N/2 (even/odd
  fold y[m] = x[2m] + i x[N-1-2m], pre-twiddle, FFT_M, post-twiddle;
  c[2j] = Re T[j], c[N-1-2j] = -Im T[j]), the FFT itself a two-stage
  Cooley-Tukey factorization M = M1 * M2 whose stages are small batched
  real matrix products ([M2, M2] then [M1, M1], the twiddles folded into
  the stage constants): 2 N (M1 + M2) multiply-adds instead of N^2, and
  a few KiB of constants instead of the dense basis pair. The DST-IV is
  dst4(x)[k] = (-1)^k dct4(reverse(x))[k].
- ``fft``: c[k] = dct4(x)[k] - i dst4(x)[k] through one complex FFT of
  length 2N over the zero-padded, pre-twiddled input (``torch.fft``).

All three are float32 transforms that agree to ~1e-6 of the block's
largest magnitude; the choice is one of speed and memory. The products of
``matmul`` and ``fact`` must not run in TF32 on the card, which keeps
about three decimal digits: PyTorch's default (``allow_tf32`` False) is
assumed and ``chip_smoke.py`` sets it explicitly. Constants are built in
float64 with numpy, cast, and moved to the input's device once per
(n, device).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _basis(n: int, fn) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    return fn(np.pi / n * np.outer(k + 0.5, k + 0.5)).astype(np.float32)


@lru_cache(maxsize=32)
def _matrices(n: int, device: torch.device):
    """(cos basis, sin basis) [n, n] on ``device``, built once per size."""
    return (
        torch.from_numpy(_basis(n, np.cos)).to(device),
        torch.from_numpy(_basis(n, np.sin)).to(device),
    )


def dct4_matmul(x: torch.Tensor) -> torch.Tensor:
    return x @ _matrices(x.shape[-1], x.device)[0]


def dst4_matmul(x: torch.Tensor) -> torch.Tensor:
    return x @ _matrices(x.shape[-1], x.device)[1]


# ---------------------------------------------------------------------------
# fft backend


@lru_cache(maxsize=32)
def _fft_twiddles(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(pre, post) complex64 twiddles of the 2N-FFT algorithm:

    c[k] = sum_n x[n] exp(-i pi (n+1/2)(k+1/2) / N)
         = post[k] * FFT_2N(pre * x, zero-padded)[k]
    with pre[n] = exp(-i pi n / (2N)), post[k] = exp(-i pi (k/2 + 1/4)/N).
    """
    nn = np.arange(n, dtype=np.float64)
    pre = np.exp(-1j * np.pi * nn / (2.0 * n)).astype(np.complex64)
    post = np.exp(-1j * np.pi * (nn / 2.0 + 0.25) / n).astype(np.complex64)
    return pre, post


@lru_cache(maxsize=32)
def _fft_twiddles_on(n: int, device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in _fft_twiddles(n))


def _c4_fft(x: torch.Tensor) -> torch.Tensor:
    """Complex c[k] = dct4(x)[k] - i*dst4(x)[k] via a 2N FFT."""
    n = x.shape[-1]
    pre, post = _fft_twiddles_on(n, x.device)
    # n=2n zero-pads the pre-twiddled input to the FFT's length
    return torch.fft.fft(x * pre, n=2 * n, dim=-1)[..., :n] * post


def dct4_fft(x: torch.Tensor) -> torch.Tensor:
    return _c4_fft(x).real.contiguous()


def dst4_fft(x: torch.Tensor) -> torch.Tensor:
    return -_c4_fft(x).imag


def dct4_dst4_fft(x_c: torch.Tensor, x_s: torch.Tensor):
    """dct4(x_c) and dst4(x_s) sharing one batched FFT."""
    c = _c4_fft(torch.stack([x_c, x_s], dim=0))
    return c[0].real.contiguous(), -c[1].imag


# ---------------------------------------------------------------------------
# fact backend. Derivation:
#
#   c[k] = sum_n x[n] cos(pi/N (n+1/2)(k+1/2))
#   y[m] = x[2m] + i x[N-1-2m],  z[m] = y[m] e^{-i pi m / N}
#   T[j] = e^{-i pi (j+1/4)/N} * FFT_M(z)[j]
#   c[2j] = Re T[j],   c[N-1-2j] = -Im T[j]
#
# FFT_M by Cooley-Tukey with m = m1 + M1*m2, j = j2 + M2*j1: an inner
# [M2, M2] DFT over m2, the twiddle W_M^{m1 j2}, an outer [M1, M1] DFT
# over m1; the output [j1, j2] flattens row-major to j = j2 + M2*j1.
# Every scalar twiddle is folded into the nearest stage constant.


@lru_cache(maxsize=32)
def _fact_consts(n: int):
    """(M1, M2, F2, mid, F1), the three constants as float32 (real,
    imag) pairs of numpy arrays; n a power of two >= 4."""
    if n < 4 or n & (n - 1):
        raise ValueError(f"the factorized transform needs a power of two >= 4, got {n}")
    m = n // 2
    m1n = 1 << ((m.bit_length() + 1) // 2)  # M1 >= M2, both powers of 2
    m2n = m // m1n
    m1 = np.arange(m1n, dtype=np.float64)
    m2 = np.arange(m2n, dtype=np.float64)
    j1 = m1
    j2 = m2
    # inner stage: W_{M2}^{m2 j2} * (m2 part of the pre-twiddle e^{-i pi m/N})
    f2 = np.exp(-2j * np.pi * np.outer(m2, j2) / m2n) * np.exp(
        -1j * np.pi * m1n * m2 / n
    )[:, None]
    # mid twiddle W_M^{m1 j2} * (m1 part of pre) * (j2 part of post)
    mid = (
        np.exp(-2j * np.pi * np.outer(j2, m1) / m)
        * np.exp(-1j * np.pi * m1 / n)[None, :]
        * np.exp(-1j * np.pi * (j2 + 0.25) / n)[:, None]
    )
    # outer stage: W_{M1}^{m1 j1} * (j1 part of post e^{-i pi M2 j1 / N})
    f1 = np.exp(-2j * np.pi * np.outer(m1, j1) / m1n) * np.exp(
        -1j * np.pi * m2n * j1 / n
    )[None, :]

    def ri(a):
        return a.real.astype(np.float32), a.imag.astype(np.float32)

    return m1n, m2n, ri(f2), ri(mid), ri(f1)


@lru_cache(maxsize=32)
def _fact_consts_on(n: int, device: torch.device):
    """``_fact_consts`` as tensors on ``device``: (M1, M2, then real and
    imaginary parts of F2 [M2, M2], mid [M2, M1], F1 [M1, M1])."""
    m1n, m2n, *pairs = _fact_consts(n)
    return (m1n, m2n, *(torch.from_numpy(a).to(device) for pair in pairs for a in pair))


def _fact_core(x: torch.Tensor):
    """(Re T, Im T) of the factorized transform, each [..., N/2]."""
    n = x.shape[-1]
    m1n, m2n, f2r, f2i, midr, midi, f1r, f1i = _fact_consts_on(n, x.device)
    lead = x.shape[:-1]
    # [..., m2, m1]: flat index m = m1 + M1*m2
    yr = x[..., 0::2].reshape(*lead, m2n, m1n)
    yi = x[..., 1::2].flip(-1).reshape(*lead, m2n, m1n)

    def cmm(ar, ai, br, bi, eq):
        rr = torch.einsum(eq, ar, br)
        ri_ = torch.einsum(eq, ar, bi)
        ir = torch.einsum(eq, ai, br)
        ii = torch.einsum(eq, ai, bi)
        return rr - ii, ri_ + ir

    # inner DFT over m2 -> [..., j2, m1]
    vr, vi = cmm(yr, yi, f2r, f2i, "...ba,bj->...ja")
    # mid twiddle (elementwise complex, [j2, m1])
    vr, vi = vr * midr - vi * midi, vr * midi + vi * midr
    # outer DFT over m1 -> [..., j1, j2]
    ur, ui = cmm(vr, vi, f1r, f1i, "...ja,ak->...kj")
    # flatten: j = j2 + M2*j1 == row-major [j1, j2]
    return ur.reshape(*lead, n // 2), ui.reshape(*lead, n // 2)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """out[2j] = even[j], out[2j+1] = odd[j], one contiguous tensor."""
    return torch.stack([even, odd], dim=-1).reshape(*even.shape[:-1], 2 * even.shape[-1])


def dct4_fact(x: torch.Tensor) -> torch.Tensor:
    tr, ti = _fact_core(x)
    return _interleave(tr, (-ti).flip(-1))


def dst4_fact(x: torch.Tensor) -> torch.Tensor:
    # dst4(x)[k] = (-1)^k dct4(rev x)[k]: even outputs unchanged, odd
    # outputs negated, which folds into the interleave
    tr, ti = _fact_core(x.flip(-1))
    return _interleave(tr, ti.flip(-1))


def dct4_dst4_fact(x_c: torch.Tensor, x_s: torch.Tensor):
    """dct4(x_c) and dst4(x_s) through one stacked factorized core, so
    the pair costs the launches of one transform."""
    tr, ti = _fact_core(torch.stack([x_c, x_s.flip(-1)], dim=0))
    ti = ti.flip(-1)
    return _interleave(tr[0], -ti[0]), _interleave(tr[1], ti[1])


# ---------------------------------------------------------------------------

_DCT4 = {"matmul": dct4_matmul, "fft": dct4_fft, "fact": dct4_fact}
_DST4 = {"matmul": dst4_matmul, "fft": dst4_fft, "fact": dst4_fact}


def dct4(x: torch.Tensor, backend: str = "matmul") -> torch.Tensor:
    return _DCT4[backend](x)


def dst4(x: torch.Tensor, backend: str = "matmul") -> torch.Tensor:
    return _DST4[backend](x)


def dct4_dst4(x_c: torch.Tensor, x_s: torch.Tensor, backend: str = "matmul"):
    """(dct4(x_c), dst4(x_s)), pair-fused where the backend allows."""
    if backend == "fact":
        return dct4_dst4_fact(x_c, x_s)
    if backend == "fft":
        return dct4_dst4_fft(x_c, x_s)
    return dct4_matmul(x_c), dst4_matmul(x_s)
