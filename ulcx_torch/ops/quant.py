"""Companded (non-linear) coefficient quantization.

Port of ``ulcx.ops.quant``. The codec quantizes x -> q with decode
q*|q| (signed square), so the companding curve is sqrt. Optimal
rounding is ``q = floor(0.5 + sqrt(v - 0.25))`` for v >= 0.5, else 0
(reference libulc/ulcHelper.h:50-91).
"""

from __future__ import annotations

import torch


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 sqrt, correctly rounded on every device. torch's CPU sqrt
    may be one ulp off (e.g. at 1056.2498779296875); the float64 root
    rounded to float32 is exact, as XLA's and CUDA's __fsqrt_rn are."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def companded_quantize_unsigned(v: torch.Tensor) -> torch.Tensor:
    """Round v (>= 0, pre-scaled by the quantizer) to its companded code.
    The int conversion saturates at INT32_MAX, as XLA's does."""
    v = torch.as_tensor(v, dtype=torch.float32)
    q = torch.floor(0.5 + sqrt_rn(torch.clamp(v - 0.25, min=0.0))).to(torch.float64)
    q = torch.where(q < 2.0**31, q, 2.0**31 - 1)
    return torch.where(v >= 0.5, q, 0.0).to(torch.int32)


def companded_quantize(v: torch.Tensor) -> torch.Tensor:
    q = companded_quantize_unsigned(torch.abs(v))
    return torch.where(v < 0, -q, q)


def companded_quantize_coef(v: torch.Tensor, limit: int) -> torch.Tensor:
    """Signed quantize with magnitude clamped to ``limit`` (7 for coefs)."""
    q = torch.clamp(companded_quantize_unsigned(torch.abs(v)), max=limit)
    return torch.where(v < 0, -q, q)


def expand_quantizer(qi: torch.Tensor) -> torch.Tensor:
    """qi (0..28, pre-bias) -> 2^-(5+qi) by the reference's exact integer
    formula ``((1<<26) >> qi) * 2^-31`` (reference ulcDecoder.c:96-98),
    including the qi > 26 -> 0 corner. Every product is exact."""
    qi = torch.as_tensor(qi, dtype=torch.int32)
    m = torch.where(qi < 27, (1 << 26) >> torch.clamp(qi, 0, 26), 0)
    return m.to(torch.float32) * 2.0**-31
