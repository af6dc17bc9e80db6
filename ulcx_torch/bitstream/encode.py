"""The encode pass of one count per stream (port of ``ulcx.bitstream.encode``).

ulcx's scan path prices and packs a block with ``encode_pass_size`` and
``encode_pass_materialize`` from ``prepare_block``'s per-block data, in
a sequential emission scan over positions. The port has no second
emission: its walks (``bitstream.encode_kernels``: the kernels, and the
whole-plane plain versions that a CPU tensor runs) give that scan's
sizes and bytes for the same count
(PARITY.md §3). So ``prepare_block``'s counterpart here is
``fast_encode.prepare_fast``, whose ``FastBlockData`` both functions
take, and each prices or packs one count per stream through the walks.
``fast_encode.search_materialize_scan`` is the scan path's rate search
on the same walks, its planes built once for all its rounds.
"""

from __future__ import annotations

import torch

from ulcx_torch.bitstream import encode_kernels as ek
from ulcx_torch.bitstream import fast_encode as fe


def _planes(fb: fe.FastBlockData, noise_run_window: str) -> fe.Planes:
    """The walk planes for the given noise-run window: "gap" needs the
    gap prefix sums that ``prepare_fast`` carries under a gap config."""
    if noise_run_window not in ("segment", "gap"):
        raise ValueError(f"bad noise_run_window {noise_run_window!r}")
    if noise_run_window == "gap" and fb.cw is None:
        raise ValueError("the gap window needs walk inputs prepared with noise_run_window='gap'")
    if noise_run_window == "segment":
        fb = fb._replace(cw=None, cwy=None)
    return fe.make_planes(fb)


def encode_pass_size(fb: fe.FastBlockData, n_out_coef, noise_run_window: str = "gap") -> torch.Tensor:
    """Block sizes in bits [B] (byte aligned) of the counts n_out_coef [B]."""
    n = torch.as_tensor(n_out_coef).to(fb.coef.device).reshape(-1)
    w = fe.window_walks(ek.KERNEL_WALKS, noise_run_window)
    return fe.round_sizes(_planes(fb, noise_run_window), fb.n_header, fe._every_slot(n), w)[:, 0]


def encode_pass_materialize(fb: fe.FastBlockData, n_out_coef, max_bytes: int,
                            noise_run_window: str = "gap"):
    """(size_bits [B], bytes [B, max_bytes] uint8) of the counts
    n_out_coef [B]."""
    n = torch.as_tensor(n_out_coef).to(fb.coef.device).reshape(-1)
    w = fe.window_walks(ek.KERNEL_WALKS, noise_run_window)
    return fe._packed(_planes(fb, noise_run_window), fb.n_header, n, max_bytes, w)
