"""Replica of the reference's FastLog approximation.

The coefficient importance ordering — and therefore which coefficients
the rate control keeps — depends on the *exact* polynomial of the
reference's FastLog (reference libulc/ulcHelper.h:124-136), so it is
reproduced bit for bit: mantissa m in [1, 2) and exponent t by integer
bit twiddling, then a fixed 4th-order polynomial in m plus t*ln(2).
Each step is one rounded f32 operation, as in ``ulcx.ops.fastlog``.
"""

from __future__ import annotations

import torch


def fast_log(x: torch.Tensor) -> torch.Tensor:
    """ln(x) approximation matching the reference (valid for x > 0, finite)."""
    x = x.to(torch.float32)
    bits = x.view(torch.int32)
    # logical shift of the u32 pattern: the sign bit lands in bit 8
    t = ((bits >> 23) & 0x1FF) - 127
    m = ((bits & 0x7FFFFF) | (127 << 23)).view(torch.float32)
    p = 0.44717955 + -0.056570851 * m
    p = -1.4699568 + p * m
    p = 2.8212026 + p * m
    p = -1.7417939 + p * m
    return p + 0.6931471806 * t.to(torch.float32)
