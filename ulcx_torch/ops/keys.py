"""Order-preserving sort-key map (port of ``ulcx.ops.keys``).

The encode walks test keep-membership by comparing these integer keys
against per-candidate thresholds taken from ONE stable sort of them
(``ulcx.bitstream.pallas_encode3`` docstring), so the map must order
exactly like the reference's float comparator, ties included.
"""

from __future__ import annotations

import torch

_INT32_MIN = -(2**31)


def monotone_i32(f: torch.Tensor) -> torch.Tensor:
    """f32 -> signed i32 preserving order. ±0.0 collapse to one key (so
    ties keep stable-index order as in IEEE comparison), and every NaN
    maps to INT32_MIN, below -inf's key 0x807fffff, as the reference's
    argsort places NaNs last under its descending comparator."""
    u = f.to(torch.float32).view(torch.int32)
    is_nan = (u & 0x7FFFFFFF) > 0x7F800000
    u = torch.where(u == _INT32_MIN, torch.zeros_like(u), u)
    m = torch.where(u < 0, (~u) ^ _INT32_MIN, u)
    return torch.where(is_nan, torch.full_like(m, _INT32_MIN), m)
