"""Kernel-backed encode pass: batched rate search and materialization.

Port of ``ulcx.bitstream.fast_encode`` and of the rate search of
ulcx's scan path (``ulcx.codec.encoder._cbr_search_ladder`` and
``_cbr_search``). ``prepare_fast`` packs an analyzed block into the
walks' per-position planes (segment geometry, noise and HF-extension
decisions, monotone importance keys); one stable sort of the keys gives
every candidate count its keep threshold (``_tc_of``). Two plans search
the coefficient count of a CBR or ABR block, both on the same walks:

- the kernel path's (``search_materialize_fast``): the seeded ladder
  (``_bracket_search``) narrows the count with size-only rounds, and the
  final round prices and packs eight candidates at once
  (``rate_search_fast`` is the same search with a size-only final round,
  which returns the count alone);
- the scan path's (``search_materialize_scan``): ulcx's exact ladder
  (``_cbr_search_ladder``, sixteen candidates a round for ceil(log16 P)
  rounds, the largest count whose size fits), or with
  ``rate_search="bisect"`` the reference's bisection (``_bisect``); the
  count found is then materialized.

Which plan a batch takes is ``ulcx_torch.codec.encoder._use_kernel``'s
choice, ulcx's. ``walks(cfg)`` picks the walks every function here
runs: the kernels, or with ``use_pallas="off"`` their plain versions on
any device.

What the TPU layout needed and this port does not: padding batches to
128 lanes, one-hot matrix products standing in for table gathers (here
plain index gathers, so no integer ever passes through a float
product), k-way where-chains for the final select, and the sort that
compacted packed words (the materialize walk stores word ``wcount``
directly).

Noise-run window: with ``noise_run_window="segment"`` (the default) the
noise amplitude is candidate-independent and ``prepare_fast`` computes
it once per line. With ``"gap"``, the reference's exact window
min(gap, 527), it depends on each candidate's next coded position:
``prepare_fast`` then also carries the exclusive line prefix sums
``cw``, ``cwy`` and ``walks(cfg)`` prices and packs with the plain p3
walks' gap mode (no kernel has it, as ulcx has no Pallas kernel for
it), while p1 and p2, whose outputs do not depend on the window, stay
the kernels. Gap takes the scan path's plan, as in ulcx.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ulcx_torch._build import kernels_on
from ulcx_torch.analysis.block import AnalyzedBlock
from ulcx_torch.bitstream import encode_kernels as ek
from ulcx_torch.bitstream.tables import segment_tables
from ulcx_torch.ops.keys import monotone_i32
from ulcx_torch.ops.scanutil import cumsum_f32
from ulcx_torch.utils.config import CodecConfig
from ulcx_torch.utils.profiling import span

N_CAND = ek.N_CAND
K_SCAN = 16  # candidates a round of the scan path's ladder: two rounds of the walks' eight
_I32 = torch.int32
_DEC_SCALE = float(np.float32(-(2.0**19)))


class FastBlockData(NamedTuple):
    """Per-block walk inputs, stream-major ([B, ...]) as in ``ulcx``.
    Noise and HF-extension quantities are constant within a coefficient
    pair, so they stay in the line domain [B, L], L = P/2."""

    coef: torch.Tensor         # [B, P] f32
    aux: torch.Tensor          # [B, P] i32: segdelta | seg_start << 16
    key: torch.Tensor          # [B, P] i32 monotone importance key
    amp_noise: torch.Tensor    # [B, L] f32 noise amplitude
    amp_lin: torch.Tensor      # [B, L] f32 HF-extension amplitude
    hf_meta: torch.Tensor      # [B, L] i32: dec_q | hf_ok << 8
    window_ctrl: torch.Tensor  # [B] i32
    header: torch.Tensor       # [B, 2] i32 window-control nybbles
    n_header: torch.Tensor     # [B] i32 header nybble count
    # noise_run_window="gap" only: exclusive prefix sums of w and w*y
    # over the lines, with the grand total last
    cw: torch.Tensor | None = None   # [B, L + 1] f32
    cwy: torch.Tensor | None = None  # [B, L + 1] f32


@lru_cache(maxsize=16)
def _prep_tables(block_size: int, n_chan: int, device: torch.device):
    """Per-pattern tables on ``device``: segdelta [16, P], is_start
    [16, P], end_line [16, L] (segment end in lines), end_slot [16, L]
    (which N/16-line grid slot that end is)."""
    with span("ulcx.build.prep_tables"):
        n = block_size
        p_tot = n * n_chan
        grid_step = (n // 8) // 2
        starts, ends, _ = segment_tables(n, n_chan)
        idxp = np.arange(p_tot)
        segdelta = np.clip(ends - idxp, 0, 0xFFFF).astype(np.int32)
        is_start = (idxp == starts).astype(np.int32)
        end_line = (ends[:, 0::2] // 2).astype(np.int32)
        end_slot = (end_line // grid_step - 1).astype(np.int64)
        return tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (segdelta, is_start, end_line, end_slot)
        )


def prepare_fast(blk: AnalyzedBlock, cfg: CodecConfig) -> FastBlockData:
    """Walk inputs of a batch of analyzed blocks (fields with leading [B]).

    The noise-run amplitude averages the noise spectrum over
    min(line + 264, segment end) lines; the HF extension fits a
    log-linear decay over the rest of the segment by least squares.
    Both come from five prefix sums over the pair (line) domain; with
    ``noise_run_window="gap"`` the first two of them go along whole, for
    the walks to average over each candidate's gap."""
    with span("ulcx.encode.bitstream.prepare"):
        n, c = cfg.block_size, cfg.n_chan
        p_tot = n * c
        nl = p_tot // 2
        n_grid = 8 * c
        grid_step = (n // 8) // 2
        b = blk.mdct.shape[0]
        dev = blk.mdct.device
        segdelta_t, isstart_t, endline_t, endslot_t = _prep_tables(n, c, dev)
        pat = (blk.window_ctrl >> 4).long()

        coef = blk.mdct.reshape(b, p_tot).contiguous()
        noise = blk.noise.reshape(b, p_tot)
        w = noise[:, 0::2]
        wy = noise[:, 1::2]
        g = torch.arange(nl, dtype=torch.float32, device=dev)

        # five prefix sums {w, w*y, w*g, w*g^2, w*y*g}, exclusive form
        incl = cumsum_f32(torch.stack([w, wy, w * g, w * g * g, wy * g], dim=1), dim=-1)
        cs = torch.cat([torch.zeros_like(incl[:, :, :1]), incl[:, :, :-1]], dim=-1)  # [B, 5, L]
        tot = incl[:, :, -1:]

        # value of each prefix sum at every line's segment end: the grid
        # slot values (the last slot is the grand total), gathered per line
        gv = torch.cat([cs[:, :, grid_step::grid_step][:, :, : n_grid - 1], tot], dim=-1)
        slot = endslot_t[pat][:, None, :].expand(b, 5, nl)
        seg_vals = torch.gather(gv, 2, slot)  # [B, 5, L]
        end_line = endline_t[pat].to(torch.float32)  # [B, L]

        cw_a, cwy_a = cs[:, 0], cs[:, 1]
        cw_end, cwy_end = seg_vals[:, 0], seg_vals[:, 1]

        # noise amplitude window = min(line + 264, segment end)
        in_window = (g + 264.0) < end_line
        take = max(0, nl - 264)

        def shifted(j):
            return torch.cat([cs[:, j, 264:], tot[:, j].expand(b, nl - take)], dim=-1)

        s_w = torch.where(in_window, shifted(0), cw_end) - cw_a
        s_wy = torch.where(in_window, shifted(1), cwy_end) - cwy_a
        amp = torch.exp(s_wy / torch.where(s_w > 0, s_w, torch.ones_like(s_w)))
        amp_noise = torch.where(s_wy != 0.0, amp, torch.zeros_like(amp))

        # HF-extension least squares over the segment tail
        af = g
        sw = cw_end - cw_a
        swy = cwy_end - cwy_a
        swg = seg_vals[:, 2] - cs[:, 2]
        swg2 = seg_vals[:, 3] - cs[:, 3]
        swyg = seg_vals[:, 4] - cs[:, 4]
        sx = 2.0 * (swg - af * sw)
        sx2 = 4.0 * (swg2 - 2.0 * af * swg + af * af * sw)
        sxy = 2.0 * (swyg - af * swy)
        det = sw * sx2 - sx * sx
        solvable = det != 0.0
        det_s = torch.where(solvable, det, torch.ones_like(det))
        amp_log = (sx2 * swy - sx * sxy) / det_s
        dec_log = (sw * sxy - sx * swy) / det_s
        amp_lin = torch.exp(amp_log)
        dec_lin = torch.where(dec_log < 0, torch.exp(dec_log), torch.ones_like(dec_log))
        dec_raw = ek.cq_unsigned((dec_lin - 1.0) * _DEC_SCALE)
        hf_ok = solvable & (dec_raw > 0)
        hf_meta = torch.clamp(dec_raw, max=255) | (hf_ok.to(_I32) << 8)

        aux = segdelta_t[pat] | (isstart_t[pat] << 16)
        key = monotone_i32(blk.importance.reshape(b, p_tot))

        wc = blk.window_ctrl.to(_I32)
        header = torch.stack([wc & 0xF, (wc >> 4) & 0xF], dim=-1)
        n_header = torch.where((wc & 0x8) != 0, 2, 1).to(_I32)
        gap = {}
        if cfg.noise_run_window == "gap":
            gap = {"cw": torch.cat([cw_a, tot[:, 0]], dim=-1),
                   "cwy": torch.cat([cwy_a, tot[:, 1]], dim=-1)}
        return FastBlockData(coef, aux, key, amp_noise, amp_lin, hf_meta, wc, header, n_header, **gap)


def _qmin_ge(m: torch.Tensor, thr_kind: str) -> torch.Tensor:
    """Smallest integer q in [0, 63] with m * 2**q >= threshold, exactly,
    from the f32 bit pattern (63 = never within q <= 31). Scaling by
    2**q only shifts the exponent, so the walks' magnitude tests
    cq_unsigned(m * 2**q) >= {1, 2} become integer compares q >= qmin:
      m >= 2.5 * 2**-q   <=>  q >= (1 if mant >= 1.25 else 2) - em
      m >= 0.5 * 2**-q   <=>  q >= -1 - em
      m >= 0.125 * 2**-q <=>  q >= -3 - em
    Zeros and denormals (em <= -127) clip to 63."""
    bits = m.to(torch.float32).view(_I32) & 0x7FFFFFFF
    em = ((bits >> 23) & 0xFF) - 127
    if thr_kind == "2.5":
        q = torch.where((bits & 0x7FFFFF) >= 0x200000, 1 - em, 2 - em)
    elif thr_kind == "0.5":
        q = -1 - em
    elif thr_kind == "0.125":
        q = -3 - em
    else:  # pragma: no cover
        raise ValueError(thr_kind)
    return torch.clamp(torch.where(bits == 0, 63, q), 0, 63)


def thr_plane(coef, amp_noise, amp_lin, hf_meta) -> torch.Tensor:
    """Packed per-position threshold plane [B, P] of the size-only walks
    (field map in ``encode_kernels``)."""
    qm0 = _qmin_ge(torch.abs(coef), "2.5")
    qm1 = torch.cat([qm0[:, 1:], qm0[:, -1:]], dim=1)
    qmn = torch.repeat_interleave(_qmin_ge(amp_noise, "0.5"), 2, dim=1)
    qmh = torch.repeat_interleave(_qmin_ge(amp_lin, "0.125"), 2, dim=1)
    hfok = torch.repeat_interleave((hf_meta >> 8) & 1, 2, dim=1)
    return qm0 | (qm1 << 6) | (qmn << 12) | (qmh << 18) | (hfok << 24)


class Planes(NamedTuple):
    """Walk input planes, position-major [P, B] (lines [P/2, B]), built
    once per block step and reused by every round. skey/sidx [B, P]
    are the (key desc, position asc) sorted keys and their positions,
    from which each round takes its candidates' keep thresholds."""

    coef: torch.Tensor
    thr: torch.Tensor
    aux: torch.Tensor
    key: torch.Tensor
    ampn: torch.Tensor
    hfamp: torch.Tensor
    hfmeta: torch.Tensor
    hdr: torch.Tensor      # [B] header nybbles | count << 8
    skey: torch.Tensor
    sidx: torch.Tensor
    gap: tuple = ()        # gap noise window: (cw, cwy) [L + 1, B], passed on to p3


def make_planes(fb: FastBlockData) -> Planes:
    """The walks' planes of one block step, with the one key sort."""

    def pb(x):
        return x.t().contiguous()

    with span("ulcx.encode.bitstream.planes"):
        hdr = (fb.header[:, 0] | (fb.header[:, 1] << 4) | (fb.n_header << 8)).to(_I32).contiguous()
        # ~key reverses the i32 order exactly, so a stable ascending sort of
        # ~key is the descending key order with ties by ascending position
        skinv, sidx = torch.sort(~fb.key, dim=1, stable=True)
        return Planes(
            coef=pb(fb.coef),
            thr=pb(thr_plane(fb.coef, fb.amp_noise, fb.amp_lin, fb.hf_meta)),
            aux=pb(fb.aux.to(_I32)),
            key=pb(fb.key),
            ampn=pb(fb.amp_noise),
            hfamp=pb(fb.amp_lin),
            hfmeta=pb(fb.hf_meta.to(_I32)),
            hdr=hdr,
            skey=~skinv,
            sidx=sidx.to(_I32),
            gap=() if fb.cw is None else (pb(fb.cw), pb(fb.cwy)),
        )


def _tc_of(pl: Planes, nn: torch.Tensor):
    """Keep thresholds (t, c) [B, 8] for candidate counts nn [B, 8]: the
    nn-th entry of the sorted order, so the walks' keep test equals
    ``stable-desc rank < nn`` exactly, ties included. nn <= 0 maps to a
    threshold nothing passes."""
    j = torch.clamp(nn - 1, 0, pl.skey.shape[1] - 1).long()
    t = torch.gather(pl.skey, 1, j)
    c = torch.gather(pl.sidx, 1, j)
    none = nn <= 0
    t = torch.where(none, 2**31 - 1, t).contiguous()
    c = torch.where(none, -1, c).contiguous()
    return t, c


def walks(cfg: CodecConfig) -> ek.Walks:
    """The walks ``cfg`` asks for: the kernels (whose wrappers run the
    plain versions on CPU tensors and launch the kernels on CUDA ones),
    or with ``use_pallas="off"`` the plain versions wherever the tensors
    lie, launching no kernel (``_build.kernels_on``), under ``cfg``'s
    noise-run window (``window_walks``)."""
    return window_walks(ek.KERNEL_WALKS if kernels_on(cfg) else ek.PLAIN_WALKS,
                        cfg.noise_run_window)


def window_walks(w: ek.Walks, noise_run_window: str) -> ek.Walks:
    """``w``, or with ``noise_run_window="gap"`` ``w`` with both p3 walks
    in the plain versions' gap mode, which take the planes' gap prefix
    sums as two more arguments."""
    if noise_run_window == "gap":
        w = w._replace(p3_size=ek.p3_size_gap_plain, p3_materialize=ek.p3_materialize_gap_plain)
    return w


def _state(pl: Planes, nn: torch.Tensor, w: ek.Walks) -> torch.Tensor:
    """Phases 1 and 2 for candidate counts nn [B, 8] -> state plane."""
    t, c = _tc_of(pl, nn.to(_I32))
    s12 = w.p1(t, c, pl.key, pl.coef, pl.aux)
    return w.p2(t, c, pl.key, pl.thr, pl.aux, s12)


def _sizes_of(bits: torch.Tensor, n_header: torch.Tensor) -> torch.Tensor:
    """Byte-aligned block size in bits from the nybble count."""
    return (4 * (bits + n_header[:, None]) + 7) & ~7


def round_sizes(pl: Planes, n_header, nn, w: ek.Walks = ek.KERNEL_WALKS) -> torch.Tensor:
    """One size-only round: byte-aligned sizes [B, 8] of candidates nn."""
    with span("ulcx.encode.bitstream.size_round"):
        return _sizes_of(w.p3_size(pl.thr, pl.aux, _state(pl, nn, w), *pl.gap), n_header)


def _materialize(pl: Planes, nn, max_bytes: int, w: ek.Walks):
    """Final round: (bits, words, freg, fwc) for candidates nn [B, 8]."""
    with span("ulcx.encode.bitstream.final"):
        return w.p3_materialize(
            pl.coef, pl.ampn, pl.hfamp, pl.hfmeta, pl.aux, _state(pl, nn, w), pl.hdr, max_bytes // 4,
            *pl.gap
        )


def _every_slot(n: torch.Tensor) -> torch.Tensor:
    """One count per stream [B] -> the same count in all eight slots."""
    return n.to(_I32)[:, None].expand(-1, N_CAND).contiguous()


def _words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """[B, n_words] int32 little-endian words -> [B, 4*n_words] uint8."""
    sh = torch.arange(4, dtype=_I32, device=words.device) * 8
    return ((words[:, :, None] >> sh) & 0xFF).to(torch.uint8).reshape(words.shape[0], -1)


def _rounds(p_tot: int) -> int:
    return max(1, int(math.ceil(math.log(p_tot, N_CAND))))


# --- interp-seeded ladder -----------------------------------------------------
#
# After one classic round, linear interpolation between the bracket edge
# sizes predicts the budget crossing closely; one round of candidates
# spread around the prediction (offsets in 1/256ths of the bracket gap)
# replaces the middle rounds, and the final round stretches its spacing
# over whatever bracket remains (``ulcx.bitstream.fast_encode``).
_SEED_W = (-51, -31, -18, -9, -4, 0, 5, 15)


def _seed_plan(rounds: int):
    """(classic size rounds, use the seeded round) before the final round:
    one classic round and the seeded one, or with too few rounds the
    classic ladder's rounds - 1, which leave the final round a bracket
    of at most 8 counts."""
    if rounds - 1 < 2:
        return rounds - 1, False
    return 1, True


def _bracket_search(size_fn, n_nz, budget, rounds: int):
    """Classic + interp-seeded ladder rounds over candidates [B, 8].
    Returns (lo, hi) [B]: the crossing bracketed, lo the best
    known-feasible count (or 0). All arithmetic is int32. The seeded
    round assumes the first round found a feasible count; where it found
    none the final round can land well under the budget, which is why
    ulcx takes this plan only where its kernels run (P <= 32768, the
    segment window, a batch of a multiple of 8)."""
    k = N_CAND
    dev = n_nz.device
    classic, seeded = _seed_plan(rounds)
    budget = budget.to(_I32)
    karr1 = torch.arange(1, k + 1, dtype=_I32, device=dev)[None]
    jidx = torch.arange(k, dtype=_I32, device=dev)[None]
    w = torch.tensor(_SEED_W, dtype=_I32, device=dev)[None]
    bud = budget[:, None]
    lo = torch.zeros_like(n_nz, dtype=_I32)
    hi = n_nz.to(_I32)
    s_lo = torch.zeros_like(lo)
    gap = torch.zeros_like(lo)
    den = torch.ones_like(lo)
    seed_ok = torch.zeros_like(lo, dtype=torch.bool)
    big = 2**30

    for is_seeded in [False] * classic + ([True] if seeded else []):
        hi_lo = torch.maximum(hi, lo)
        step = torch.clamp((hi - lo + k - 1) // k, min=1)
        std = lo[:, None] + step[:, None] * karr1
        n_star = torch.minimum(torch.maximum(lo + (budget - s_lo) * gap // den, lo), hi_lo)
        off = (gap[:, None] * w) >> 8
        sc = torch.minimum(torch.maximum(n_star[:, None] + off, lo[:, None]), hi_lo[:, None])
        cands = torch.where((seed_ok & is_seeded)[:, None], sc, std)
        cands_c = torch.minimum(cands, torch.clamp(hi, min=0)[:, None])
        sizes = size_fn(cands_c)

        beyond = cands > hi[:, None]
        feas = (sizes <= bud) & ~beyond
        any_f = feas.any(dim=1)
        best = torch.where(feas, cands_c, lo[:, None]).amax(dim=1)
        fbad = torch.where(feas | beyond, big, cands).amin(dim=1)
        # bracket-edge sizes: candidates ascend, so the largest feasible
        # index holds the largest feasible count, the smallest bad the smallest
        bestj = torch.where(feas, jidx, -1).amax(dim=1)
        badj = torch.where(feas | beyond, k, jidx).amin(dim=1)
        s_lo = torch.where(jidx == bestj[:, None], sizes, 0).sum(dim=1, dtype=_I32)
        s_hi = torch.where(jidx == badj[:, None], sizes, 0).sum(dim=1, dtype=_I32)
        new_lo = torch.where(any_f, best, lo)
        hi = torch.minimum(hi, fbad - 1)
        seed_ok = any_f & (fbad < big) & (fbad > new_lo)
        gap = fbad - new_lo
        den = torch.clamp(s_hi - s_lo, min=1)
        lo = new_lo
    return lo, hi


def _final_cands(lo, hi):
    """Final-round grid lo + s*(0..7): spacing s stretches to cover the
    remaining bracket (s = 1 finds the exact largest feasible count)."""
    hi_c = torch.maximum(hi, lo)
    s = torch.clamp(-((lo - hi_c) // (N_CAND - 1)), min=1)
    jidx = torch.arange(N_CAND, dtype=_I32, device=lo.device)[None]
    cands = lo[:, None] + s[:, None] * jidx
    return torch.minimum(cands, hi_c[:, None])


def _cbr_search_ladder(size_fn, n_nz, budget, p_tot: int, k: int = K_SCAN):
    """ulcx's scan-path rate search (``ulcx.codec.encoder.
    _cbr_search_ladder``), step for step for a batch: ceil(log_k P)
    rounds each price k candidate counts per stream (``size_fn``: counts
    [B, k] -> sizes [B, k]) and narrow the bracket k-fold. Exact: the
    largest count whose size fits the budget wherever Size(n) is
    monotone. Returns the count [B]."""
    rounds = max(1, int(math.ceil(math.log(p_tot, k))))
    karr1 = torch.arange(1, k + 1, dtype=_I32, device=n_nz.device)[None]
    bud = budget.to(_I32)[:, None]
    lo = torch.zeros_like(n_nz, dtype=_I32)
    hi = n_nz.to(_I32)
    for _ in range(rounds):
        step = torch.clamp((hi - lo + k - 1) // k, min=1)
        cands = lo[:, None] + step[:, None] * karr1
        cands_c = torch.minimum(cands, torch.clamp(hi, min=0)[:, None])
        sizes = size_fn(cands_c)
        feas = (sizes <= bud) & (cands <= hi[:, None])
        # largest feasible candidate -> new lo; smallest infeasible -> bound
        best = torch.where(feas, cands_c, lo[:, None]).amax(dim=1)
        first_bad = torch.where(feas | (cands > hi[:, None]), 2**30, cands).amin(dim=1)
        lo = torch.where(feas.any(dim=1), best, lo)
        hi = torch.minimum(hi, first_bad - 1)
    return lo


def _bisect(size_fn, n_nz, budget, p_tot: int):
    """The reference's bisection (ulcEncoder.c:98-115), step for step as
    ``ulcx.codec.encoder._cbr_search``: ceil(log2 P) + 1 rounds, each
    pricing one count per stream (``size_fn``: counts [B] -> sizes [B]),
    a stream's bracket frozen once it is done. Returns the count [B]."""
    n_iter = int(math.ceil(math.log2(p_tot))) + 1
    lo = torch.zeros_like(n_nz, dtype=_I32)
    hi = n_nz.to(_I32)
    done = ~(lo < hi)
    for _ in range(n_iter):
        n = (lo + hi) // 2
        size = size_fn(n)
        eq = size == budget
        lo2 = torch.where(eq, n, torch.where(size < budget, n, lo))
        hi2 = torch.where(eq, hi, torch.where(size > budget, n - 1, hi))
        done2 = done | eq | (lo2 >= hi2 - 1)
        lo = torch.where(done, lo, lo2)
        hi = torch.where(done, hi, hi2)
        done = done | done2
    return lo


def _rate_search(pl: Planes, n_header, n_nz, budget, cfg: CodecConfig, w: ek.Walks):
    """The scan path's count search (ulcx ``encoder._rate_search``):
    ``rate_search="bisect"`` the bisection, else the exact ladder, each
    round priced by the walks, sixteen candidates as two rounds of
    eight. Returns the count [B]."""
    p_tot = pl.coef.shape[0]
    budget = budget.to(_I32)
    if cfg.rate_search == "bisect":
        return _bisect(lambda n: round_sizes(pl, n_header, _every_slot(n), w)[:, 0],
                       n_nz, budget, p_tot)

    def size_fn(nn):
        return torch.cat([round_sizes(pl, n_header, nn[:, j: j + N_CAND], w)
                          for j in range(0, K_SCAN, N_CAND)], dim=1)

    return _cbr_search_ladder(size_fn, n_nz, budget, p_tot)


def total_sizes(fb: FastBlockData, nout: torch.Tensor, cfg: CodecConfig) -> torch.Tensor:
    """Byte-aligned block sizes in bits for candidate counts nout [B, 8]."""
    return round_sizes(make_planes(fb), fb.n_header, nout.to(_I32), walks(cfg))


def _packed(pl: Planes, n_header, n_out, max_bytes: int, w: ek.Walks):
    """(size_bits [B], bytes [B, max_bytes]) of one count per stream."""
    bits, words, _, _ = _materialize(pl, _every_slot(n_out), max_bytes, w)
    return _sizes_of(bits[:, :1], n_header)[:, 0], _words_to_bytes(words[:, 0])


def materialize_fast(fb: FastBlockData, n_out, cfg: CodecConfig, max_bytes: int):
    """Byte streams for chosen counts n_out [B]. Returns (size_bits [B],
    bytes [B, max_bytes])."""
    return _packed(make_planes(fb), fb.n_header, n_out, max_bytes, walks(cfg))


def cand_count(b: int, p_tot: int) -> int:
    """Candidates a round of the kernel path's ladder: the walks' eight,
    at every batch and P (ulcx's signature)."""
    return N_CAND


def _seeded_final_cands(pl: Planes, n_header, n_nz, budget, w: ek.Walks):
    """The kernel path's seeded ladder up to its final round: the
    final round's candidates [B, 8] (ascending, the first the best count
    the bracketing rounds found feasible)."""
    lo, hi = _bracket_search(lambda nn: round_sizes(pl, n_header, nn, w), n_nz.to(_I32),
                             budget, _rounds(pl.coef.shape[0]))
    return _final_cands(lo, hi)


def _best_slot(sizes, budget) -> torch.Tensor:
    """The final round's choice [B]: the last slot whose size fits the
    budget, or slot 0 (the bracket's feasible end, always a fallback).
    No ``cands <= hi`` gate: a clipped candidate equals the bracket's
    end and stays selectable."""
    feas = sizes <= budget[:, None]
    feas[:, 0] = True
    jidx = torch.arange(N_CAND, device=sizes.device)[None]
    return torch.where(feas, jidx, 0).amax(dim=1)


def rate_search_fast(fb: FastBlockData, n_nz, budget, cfg: CodecConfig) -> torch.Tensor:
    """The kernel path's seeded ladder without materialization: the
    final round priced by a size walk. Candidate for candidate the
    search of ``search_materialize_fast``, so both return the same
    count [B]. Launches p1, p2 and p3 size three times each at P >= 512,
    and p3 materialize never."""
    pl = make_planes(fb)
    w = walks(cfg)
    budget = budget.to(_I32)
    cands_c = _seeded_final_cands(pl, fb.n_header, n_nz, budget, w)
    best_j = _best_slot(round_sizes(pl, fb.n_header, cands_c, w), budget)
    return cands_c.gather(1, best_j[:, None])[:, 0]


def search_materialize_fast(fb: FastBlockData, n_nz, budget, cfg: CodecConfig, max_bytes: int):
    """CBR/ABR on the kernel path's plan: the seeded ladder, with the
    final round fused into materialization (every candidate is priced
    and packed; each stream keeps its best feasible one). ulcx ignores
    ``rate_search`` on this plan, and so does the port.
    Returns (n_out [B], size_bits [B], bytes [B, max_bytes])."""
    b = fb.coef.shape[0]
    pl = make_planes(fb)
    w = walks(cfg)
    budget = budget.to(_I32)
    cands_c = _seeded_final_cands(pl, fb.n_header, n_nz, budget, w)
    bits, words, _, _ = _materialize(pl, cands_c, max_bytes, w)
    sizes = _sizes_of(bits, fb.n_header)
    best_j = _best_slot(sizes, budget)
    rows = torch.arange(b, device=sizes.device)
    return (
        cands_c[rows, best_j],
        sizes[rows, best_j],
        _words_to_bytes(words[rows, best_j]),
    )


def search_materialize_scan(fb: FastBlockData, n_nz, budget, cfg: CodecConfig, max_bytes: int):
    """CBR/ABR on the scan path's plan (ulcx ``encode_analyzed_cbr``):
    ``_rate_search`` finds each stream's count, which is then
    materialized once. Returns (n_out [B], size_bits [B],
    bytes [B, max_bytes])."""
    pl = make_planes(fb)
    w = walks(cfg)
    n_out = _rate_search(pl, fb.n_header, n_nz.to(_I32), budget, cfg, w)
    return (n_out, *_packed(pl, fb.n_header, n_out, max_bytes, w))
