"""The encode walks' share of their memory roofline: the least time the
card could take to move the bytes the cell's rate-search plan needs, at
3.35 TB/s (one H100 SXM's HBM3, NVIDIA's data sheet), over the walks'
device time (``p1_kernel``, ``p2_kernel``, ``p3_kernel``), per block step.

The bytes follow the problem, not the kernels that carry it: a round of
8 candidates reads each of its input planes once and writes each output
once. A size round prices the candidates (p1: forward zone scan, p2:
reverse backfill, p3: emission sizes); the final round prices and packs
the chosen count (p1, p2, p3 materialize). The plan is the port's route
(``codec.encoder._use_kernel``): the seeded ladder, 2 size rounds, for a
bitstream batch of a multiple of 8 at P <= 32768 (a multiple of 128)
with the segment noise window; else the exact ladder, 2 x ceil(log16 P)
size rounds. Planes are [P, B] 32-bit words (P = channels x block size);
the walk state [P, B, 8].
"""

import math

HBM_BYTES_PER_S = 3.35e12
N_CAND = 8
WALKS = ("p1_kernel", "p2_kernel", "p3_kernel")


def round_bytes(batch: int, positions: int) -> dict:
    """Bytes of each walk of one round of 8 candidates."""
    plane = positions * batch * 4          # key, coef, aux, thr: [P, B]
    half = positions // 2 * batch * 4      # ampn, hfamp, hfmeta: [P/2, B]
    state = N_CAND * plane                 # s12, state: [P, B, 8]
    cands = batch * N_CAND * 4             # t, c, bits, freg, fwc: [B, 8]
    words = batch * N_CAND * (positions // 2) * 4  # a block's words: at most 2 P bytes
    return {
        "p1": 2 * cands + 3 * plane + state,
        "p2": 2 * cands + 3 * plane + 2 * state,
        "p3_size": 2 * plane + state + cands,
        "p3_materialize": 2 * plane + 3 * half + state + batch * 4 + 3 * cands + words,
    }


def size_rounds(batch: int, positions: int) -> int:
    if positions <= 32768 and positions % 128 == 0 and batch % 8 == 0:
        return 2
    return 2 * math.ceil(math.log(positions, 16))


def pass_bytes(batch: int, positions: int) -> int:
    """Bytes one block's rate search and final round need for a batch."""
    r = round_bytes(batch, positions)
    return (size_rounds(batch, positions) * (r["p1"] + r["p2"] + r["p3_size"])
            + r["p1"] + r["p2"] + r["p3_materialize"])


def read(view):
    if view is None or view.params.get("path") != "encode":
        return None
    us = view.kernel_us(*WALKS)
    if us <= 0:
        return None
    p = view.params
    bound_s = pass_bytes(p["streams"], p["positions"]) / HBM_BYTES_PER_S
    return 100.0 * bound_s / (us / 1e6 / view.steps)
