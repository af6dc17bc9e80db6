"""Type-IV DCT/DST as dense float32 matrix products.

    dct4(x)[k] = sum_n x[n] * cos(pi/N * (n+1/2) * (k+1/2))
    dst4(x)[k] = sum_n x[n] * sin(pi/N * (n+1/2) * (k+1/2))

Port of the ``matmul`` backend of ``ulcx.ops.dct``: one [.., N] @ [N, N]
product with a basis built in float64 and cast to float32. The
factorized (``fact``) and FFT backends are not ported yet; callers
reject configurations that would select them (``utils.config``).
A float32 product on the card must not run in TF32, which keeps about
three decimal digits: PyTorch's default (``allow_tf32`` False) is
assumed and ``chip_smoke.py`` sets it explicitly.
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


def _check_backend(backend: str) -> None:
    if backend != "matmul":
        raise NotImplementedError(
            f"transform backend {backend!r} is not ported: ROADMAP A.7"
        )


def dct4(x: torch.Tensor, backend: str = "matmul") -> torch.Tensor:
    _check_backend(backend)
    return x @ _matrices(x.shape[-1], x.device)[0]


def dst4(x: torch.Tensor, backend: str = "matmul") -> torch.Tensor:
    _check_backend(backend)
    return x @ _matrices(x.shape[-1], x.device)[1]


def dct4_dst4(x_c: torch.Tensor, x_s: torch.Tensor, backend: str = "matmul"):
    """(dct4(x_c), dst4(x_s))."""
    return dct4(x_c, backend), dst4(x_s, backend)
