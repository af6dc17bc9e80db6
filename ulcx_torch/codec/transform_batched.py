"""Batched lapped transforms (port of ``ulcx.codec.transform_batched``).

Window patterns only ever use subblocks of four size classes N, N/2,
N/4, N/8 at fixed offsets: 15 candidate subblocks in all. Every
candidate of every class is transformed for the whole batch (one
matrix product per class), with per-candidate boundary overlaps from
static tables. The forward transform then takes, per coefficient, the
class each stream's pattern uses; the plain inverse (``imdct_plain``)
synthesizes every candidate and accumulates each under its activity
mask. Data-dependent selects (the lap reshuffle, the last subblock's
shift) are index gathers.

On the card the inverse is one hand-written kernel (``imdct``,
``csrc/imdct.cu``): per row it synthesizes only the active subblocks of
its pattern, each by a fast DCT-IV (an FFT of half its length,
``csrc/dct4.cuh``), and windows and laps them with the plain version's
sums in the plain version's order.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ulcx_torch._build import check as _check
from ulcx_torch._build import kernel, kernels_on
from ulcx_torch._build import launch as _launch
from ulcx_torch.ops.dct import dct4_dst4
from ulcx_torch.ops.mdct import imdct_expand, imdct_halfspec, mdct_fold, mdst_fold, rise_window
from ulcx_torch.ops.patterns import (
    pattern_subblock_offsets,
    pattern_subblock_sizes,
    pattern_transient_flags,
)
from ulcx_torch.utils.config import CodecConfig
from ulcx_torch.utils.profiling import span

N_CLASSES = 4


def candidate_list():
    """[(class, position)] for all 15 candidate subblocks, ordered by
    class, then by position."""
    return [(c, i) for c in range(N_CLASSES) for i in range(1 << c)]


@lru_cache(maxsize=2)
def _cand_order() -> np.ndarray:
    """Total order of candidates by coefficient offset (N/8 units),
    class as tiebreak (co-active candidates always differ in offset)."""
    return np.array([(i * (8 >> c)) * 4 + c for c, i in candidate_list()], np.int32)


@lru_cache(maxsize=8)
def candidate_tables(block_size: int):
    """Static per-pattern candidate tables (numpy int32).

    [16, 15]: act (candidate present in pattern), l_flag (its transient
    flag), l_prev (previous subblock's class shift, or -1 => the
    previous block's last subblock size), r_shift (next subblock's
    class shift, or -1 => next block's leading overlap), r_flag (next
    subblock's transient flag); plus class maps cls_coef [16, N] and
    cls_line [16, N/2]."""
    n = block_size
    cands = candidate_list()
    ncand = len(cands)
    cand_idx = {ci: k for k, ci in enumerate(cands)}
    act = np.zeros((16, ncand), np.int32)
    l_flag = np.zeros((16, ncand), np.int32)
    l_prev = np.full((16, ncand), -1, np.int32)
    r_shift = np.full((16, ncand), -1, np.int32)
    r_flag = np.zeros((16, ncand), np.int32)
    cls_coef = np.zeros((16, n), np.int32)
    cls_line = np.zeros((16, n // 2), np.int32)
    for pat in range(16):
        pi = pat or 1
        sizes = pattern_subblock_sizes(pi, n)
        offs = pattern_subblock_offsets(pi, n)
        flags = pattern_transient_flags(pi)
        shifts = [int(np.log2(n // s)) for s in sizes]
        for s, (sz, off, fl, sh) in enumerate(zip(sizes, offs, flags, shifts)):
            k = cand_idx[(sh, off // sz)]
            act[pat, k] = 1
            l_flag[pat, k] = int(fl)
            if s > 0:
                l_prev[pat, k] = shifts[s - 1]
            if s + 1 < len(sizes):
                r_shift[pat, k] = shifts[s + 1]
                r_flag[pat, k] = int(flags[s + 1])
            cls_coef[pat, off : off + sz] = sh
            cls_line[pat, off // 2 : off // 2 + sz // 2] = sh
    return dict(
        act=act,
        l_flag=l_flag,
        l_prev=l_prev,
        r_shift=r_shift,
        r_flag=r_flag,
        cls_coef=cls_coef,
        cls_line=cls_line,
    )


@lru_cache(maxsize=8)
def device_tables(block_size: int, device: torch.device):
    """``candidate_tables`` as tensors on ``device``, plus each
    candidate's class shift [15] and, per pattern, its first and last
    active candidate [16], each candidate's next active one [16, 15], and
    int32 [16] its first subblock's shift and transient flag (pattern 0
    as ulcx reads it: one long subblock, no flag) and its last
    subblock's size."""
    with span("ulcx.build.device_tables"):
        t = {k: torch.from_numpy(v).to(device) for k, v in candidate_tables(block_size).items()}
        t["c_shift"] = torch.tensor([c for c, _ in candidate_list()], dtype=torch.int32, device=device)
        order = torch.from_numpy(_cand_order()).to(device)
        t["first"] = _first_active(t["act"], order)
        t["last"] = _last_active(t["act"], order)
        t["next"] = torch.stack([_next_active(t["act"], order, k) for k in range(order.numel())], 1)
        t["first_shift"] = t["c_shift"][t["first"]]
        t["first_flag"] = torch.tensor([pattern_transient_flags(p)[0] for p in range(16)],
                                       dtype=torch.int32, device=device)
        t["last_size"] = block_size >> t["c_shift"][t["last"]]
        return t


def boundary_overlaps_batched(window_ctrl, prev_last_ss, next_overlap, cfg: CodecConfig):
    """Per-candidate (o_left, o_right) [B, 15] int32: the overlap
    nominal and clamping rules of reference ulcDecoder.c:233-239 /
    ulcEncoder_BlockTransform.c:161-172 for all candidates at once."""
    return _overlaps(window_ctrl, prev_last_ss, next_overlap, cfg.block_size)


def _overlaps(window_ctrl, prev_last_ss, next_overlap, n: int):
    """``boundary_overlaps_batched`` at block size ``n``."""
    t = device_tables(n, window_ctrl.device)
    pat = (window_ctrl >> 4).long()
    scale = (window_ctrl & 0x7)[:, None]
    sizes = n >> t["c_shift"]
    zero = torch.zeros_like(scale)

    l_flag, l_prev = t["l_flag"][pat], t["l_prev"][pat]
    r_shift, r_flag = t["r_shift"][pat], t["r_flag"][pat]

    l_nom = sizes >> torch.where(l_flag == 1, scale, zero)
    prev_sz = torch.where(l_prev >= 0, n >> l_prev.clamp(min=0), prev_last_ss[:, None])
    o_l = torch.minimum(l_nom, prev_sz)

    r_nom = (n >> r_shift.clamp(min=0)) >> torch.where(r_flag == 1, scale, zero)
    r_nom = torch.where(r_shift >= 0, r_nom, next_overlap[:, None])
    o_r = torch.minimum(r_nom, sizes)
    return o_l.to(torch.int32), o_r.to(torch.int32)


def block_mdct_mdst_batched(samples, window_ctrl, prev_last_ss, next_overlap, cfg: CodecConfig):
    """Batched forward transform: samples [B, C, 2N] -> (mdct, mdst)
    [B, C, N], each normalized by 2/SubBlockSize."""
    with span("ulcx.encode.analysis.transform"):
        n = cfg.block_size
        b, c, _ = samples.shape
        o_l, o_r = boundary_overlaps_batched(window_ctrl, prev_last_ss, next_overlap, cfg)

        outs_c, outs_s = [], []
        k = 0
        for cls in range(N_CLASSES):
            ss = n >> cls
            npos = 1 << cls
            # frame i starts at N/2 + i*ss - ss/2 and spans 2*ss samples
            start = n // 2 - ss // 2
            frames = samples[..., start : start + (npos + 1) * ss].unfold(-1, 2 * ss, ss)
            wl = rise_window(ss, o_l[:, k : k + npos])
            wr = rise_window(ss, o_r[:, k : k + npos]).flip(-1)
            z = frames * torch.cat([wl, wr], dim=-1)[:, None]  # [B, C, npos, 2ss]
            mc, ms = dct4_dst4(mdct_fold(z), mdst_fold(z), cfg.transform_for(ss))
            norm = 2.0 / ss
            outs_c.append((-mc * norm).reshape(b, c, n))
            outs_s.append((-ms * norm).reshape(b, c, n))
            k += npos

        cls_coef = device_tables(n, samples.device)["cls_coef"][(window_ctrl >> 4).long()].long()
        return select_class(outs_c, cls_coef), select_class(outs_s, cls_coef)


def select_class(per_class, cls_coef):
    """per_class: 4 tensors [B, ..., N]; cls_coef [B, N] (a row of
    ``cls_coef`` per stream) -> [B, ..., N] taking class cls_coef at each
    coefficient (the middle axes broadcast): one stack, one gather."""
    stacked = torch.stack(per_class, dim=-1)
    idx = cls_coef.long()
    while idx.dim() < stacked.dim() - 1:
        idx = idx[:, None]
    idx = idx.expand(stacked.shape[:-1])[..., None]
    return torch.gather(stacked, -1, idx)[..., 0]


def _first_active(act, order):
    """[..., 15] activity -> [...] index of the earliest active candidate."""
    return torch.argmin(torch.where(act == 1, order, 1 << 20), dim=-1)


def _last_active(act, order):
    """[..., 15] activity -> [...] index of the latest active candidate."""
    return torch.argmax(torch.where(act == 1, order, -1), dim=-1)


def _next_active(act, order, ki: int):
    """[...] index of the first active candidate after candidate ``ki``
    (0 when there is none, as ulcx's argmin of all-sentinel keys)."""
    later = (act == 1) & (order > order[ki])
    return torch.argmin(torch.where(later, order, 1 << 20), dim=-1)


def last_subblock_size(window_ctrl, cfg: CodecConfig) -> torch.Tensor:
    """[...] int32: the size of each block's last subblock, which the next
    block's overlap sees (reference ulcDecoder.c:233-239). It depends on
    the window control alone, so a stream's lap chain can be laid out
    before its blocks are synthesized (``decoder.decode_stream_pipelined``)."""
    return last_size_of(window_ctrl, cfg.block_size)


def last_size_of(window_ctrl, block_size: int) -> torch.Tensor:
    """``last_subblock_size`` at block size ``block_size``."""
    return device_tables(block_size, window_ctrl.device)["last_size"][(window_ctrl >> 4).long()]


def block_imdct_batched(coefs, window_ctrl, lap, prev_last_ss, cfg: CodecConfig):
    """Batched inverse: coefs [B, C, N], window_ctrl [B], lap [B, C, N/2],
    prev_last_ss [B] -> (pcm [B, C, N], new_lap [B, C, N/2], last_ss [B]).

    On the card one kernel (``imdct``) synthesises each row's active
    subblocks by a fast DCT-IV and windows and laps them. On the CPU, and
    with ``use_pallas="off"``, the plain version (``imdct_plain``): every
    candidate of a class through one DCT-IV product per class, then
    ``imdct_lap_plain``."""
    with span("ulcx.decode.imdct"):
        args = (coefs.contiguous(), window_ctrl.contiguous(), lap.contiguous(),
                prev_last_ss.contiguous(), cfg.transform_for)
        return (imdct if kernels_on(cfg) else imdct.plain)(*args)


def class_halfspecs(coefs, transform_for):
    """The four classes' half-spectra of every candidate, [B, C, N] each
    (class c's 2^c candidates of N/2^c values back to back), through one
    DCT-IV product a class with backend ``transform_for(size)``."""
    b, c, n = coefs.shape
    return [imdct_halfspec(coefs.reshape(b, c, 1 << cls, n >> cls),
                           transform_for(n >> cls)).reshape(b, c, n).contiguous()
            for cls in range(N_CLASSES)]


def imdct_plain(coefs, window_ctrl, lap, prev_last_ss, transform_for):
    """The inverse transform in plain tensor code: ``class_halfspecs``,
    then ``imdct_lap_plain``."""
    return imdct_lap_plain(class_halfspecs(coefs, transform_for), window_ctrl, lap, prev_last_ss)


def imdct_lap_plain(v, window_ctrl, lap, prev_last_ss):
    """Windowing and lap of the inverse transform, in plain tensor code on
    whatever device its inputs lie: v, the four classes' half-spectra
    [B, C, N] (class c's 2^c candidates of N/2^c values back to back),
    window_ctrl [B], lap [B, C, N/2], prev_last_ss [B] -> (pcm [B, C, N],
    new_lap [B, C, N/2], last_ss [B]).

    Every candidate of a class is windowed at once; the candidates'
    halves are added into the output in candidate order, as ulcx adds
    them (each under its activity mask)."""
    b, c, n = v[0].shape
    h = n // 2
    dev = lap.device
    t = device_tables(n, dev)
    pat = (window_ctrl >> 4).long()
    act = t["act"][pat] == 1  # [B, 15]
    o_l, _ = _overlaps(window_ctrl, prev_last_ss, torch.full_like(window_ctrl, n), n)
    j = torch.arange(n, device=dev)
    ext = torch.zeros((b, c, n + h), dtype=torch.float32, device=dev)

    # the previous block's deferred-window contribution: around
    # fs = h - prev_last_ss/2 the lap reads as identity prefix, reversed
    # middle, shifted tail, then zeros; nothing when prev_last_ss is no
    # subblock size (0 at a stream's start)
    fs = (h - prev_last_ss // 2).long()[:, None]  # [B, 1]
    src = torch.where(j < fs, j, torch.where(j < h, h - 1 - j + fs, j - h + fs))
    known = (prev_last_ss[:, None] == (n >> t["c_shift"])).any(dim=-1)[:, None]
    live = known & (j < n - fs)
    pc = torch.gather(lap, -1, torch.where(live, src, 0)[:, None].expand(b, c, n))
    first_ol = o_l.gather(1, t["first"][pat][:, None])[:, 0]
    w_prev = rise_window(n, first_ol).flip(-1)  # [B, N]
    ext[..., :n] += torch.where(live[:, None], pc, 0.0) * w_prev[:, None]

    last_k = t["last"][pat]  # [B]
    last_ss = t["last_size"][pat]
    is_last = last_k[:, None] == torch.arange(act.shape[1], device=dev)  # [B, 15]
    o_r = torch.clamp(o_l.gather(1, t["next"][pat]), max=(n >> t["c_shift"]))  # [B, 15]

    v_last = torch.zeros((b, c, h), dtype=torch.float32, device=dev)
    k = 0
    for cls in range(N_CLASSES):
        ss = n >> cls
        npos = 1 << cls
        cand = slice(k, k + npos)
        vc = v[cls].reshape(b, c, npos, ss)
        wl = rise_window(ss, o_l[:, cand])  # [B, npos, ss]
        wr = rise_window(ss, o_r[:, cand]).flip(-1)
        w = torch.cat([wl, torch.where(is_last[:, cand, None], 0.0, wr)], dim=-1)
        w = torch.where(act[:, cand, None], w, 0.0)
        y = imdct_expand(vc) * w[:, None]  # [B, C, npos, 2ss]
        # frame i starts at h - ss/2 + i*ss: its first half meets frame
        # i-1's second half; the end-of-block frame's second half waits
        # in the lap (v_last)
        a = h - ss // 2
        if npos > 1:
            ext[..., a + ss : a + npos * ss] += y[..., :-1, ss:].reshape(b, c, -1)
        ext[..., a : a + npos * ss] += y[..., :ss].reshape(b, c, -1)
        here = is_last[:, cand]  # [B, npos]
        pick = here.long().argmax(dim=1)[:, None, None, None].expand(b, c, 1, ss // 2)
        vi = torch.gather(vc[..., : ss // 2], 2, pick)[:, :, 0]
        v_last = torch.where(here.any(dim=1)[:, None, None],
                             torch.nn.functional.pad(vi, (0, h - ss // 2)), v_last)
        k += npos

    # new lap: the spill left of f_new = h - last_ss/2, then v_last
    # shifted right by f_new
    jh = j[:h]
    f_new = (h - last_ss // 2).long()[:, None]
    shifted = torch.gather(v_last, -1, (jh - f_new).clamp(min=0)[:, None].expand(b, c, h))
    new_lap = torch.where((jh < f_new)[:, None], ext[..., n : n + h], shifted)
    return ext[..., :n], new_lap, last_ss


# Launch geometry of the inverse transform's kernel (csrc/imdct.cu): a CTA
# a row (stream, channel), IMDCT_THREADS threads up to IMDCT_SMALL_MAX_N,
# IMDCT_LARGE_THREADS above.
IMDCT_THREADS = 256
IMDCT_LARGE_THREADS = 1024
IMDCT_SMALL_MAX_N = 4096
# the packed tables' parts, in the kernel's order (kAct .. kCShift)
LAP_TABLE_PARTS = ("act", "l_flag", "l_prev", "next", "first", "last", "c_shift")


def imdct_geometry(b: int, c: int, n: int) -> dict:
    """The kernel's launch at B = b, C = c, N = n: threads a CTA and its
    dynamic shared memory, the row's N/2 complex half-spectrum values at
    one float2 per 32 of padding (rounded up to 16 bytes) and its N/2 lap
    floats; the grid is a CTA a row."""
    if b < 1 or c < 1:
        raise ValueError(f"empty batch: B={b}, C={c}")
    if n < 16 or n > 32768 or n & (n - 1):
        raise ValueError(f"block size {n} (a power of two from 16 to 32768)")
    spec = n // 2 + n // 64
    return {"threads": IMDCT_THREADS if n <= IMDCT_SMALL_MAX_N else IMDCT_LARGE_THREADS,
            "shared": 8 * (spec + spec % 2) + 4 * (n // 2)}


@lru_cache(maxsize=8)
def lap_tables(block_size: int, device: torch.device) -> torch.Tensor:
    """``device_tables``' parts that the kernel reads (``LAP_TABLE_PARTS``),
    flattened into one int32 tensor on ``device``."""
    with span("ulcx.build.lap_tables"):
        t = device_tables(block_size, torch.device("cpu"))
        return torch.cat([t[k].reshape(-1).to(torch.int32) for k in LAP_TABLE_PARTS]).to(device)


@lru_cache(maxsize=8)
def lap_windows(block_size: int, device: torch.device) -> torch.Tensor:
    """The sine of every even power-of-two overlap o = 2, 4, ..., N,
    back to back (o's at offset o - 2; 2 N - 2 floats): ``rise_window(o,
    o)``, on ``device``, whose values are those that the plain version's
    windows of overlap o take there over their transition."""
    with span("ulcx.build.lap_windows"):
        return torch.cat([rise_window(1 << e, torch.tensor([1 << e], device=device))[0]
                          for e in range(1, block_size.bit_length())])


@lru_cache(maxsize=8)
def dct4_twiddle_table(block_size: int) -> np.ndarray:
    """The fast DCT-IV's twiddles (``csrc/dct4.cuh``), computed in float64
    and rounded to float32 pairs (re, im), [17 N / 8, 2]: W_{N/2}^k =
    e^{-2 pi i k / (N/2)} for k < N/4, then for each class c (S = N >> c,
    M = S/2) its pre-twiddles e^{-i pi m / S}, m < M, and post-twiddles
    e^{-i pi (j + 1/4) / S}, j < M."""
    n = block_size
    k = np.arange(n // 4, dtype=np.float64)
    parts = [np.exp(-4j * np.pi * k / n)]
    for cls in range(N_CLASSES):
        s = n >> cls
        i = np.arange(s // 2, dtype=np.float64)
        parts += [np.exp(-1j * np.pi * i / s), np.exp(-1j * np.pi * (i + 0.25) / s)]
    t = np.concatenate(parts)
    return np.stack([t.real, t.imag], -1).astype(np.float32)


@lru_cache(maxsize=8)
def dct4_twiddles(block_size: int, device: torch.device) -> torch.Tensor:
    """``dct4_twiddle_table`` on ``device``."""
    with span("ulcx.build.dct4_twiddles"):
        return torch.from_numpy(dct4_twiddle_table(block_size)).to(device)


@kernel(imdct_plain)
def imdct(coefs, window_ctrl, lap, prev_last_ss, transform_for):
    """The inverse transform in one kernel (``csrc/imdct.cu``; it replaces
    no TPU kernel, but what ``imdct_plain`` computes in four DCT-IV
    products and some 300 tensor ops) -> (pcm, new_lap, last_ss); see
    ``block_imdct_batched``. On CPU tensors it runs ``imdct_plain`` with
    the DCT-IV backends ``transform_for`` picks; the kernel takes its own
    fast DCT-IV and does not read it."""
    b, c, n = coefs.shape
    g = imdct_geometry(b, c, n)
    _check("coefs", coefs, torch.float32, (b, c, n))
    _check("window_ctrl", window_ctrl, torch.int32, (b,))
    _check("lap", lap, torch.float32, (b, c, n // 2))
    _check("prev_last_ss", prev_last_ss, torch.int32, (b,))
    dev = lap.device
    tables, win, tw = lap_tables(n, dev), lap_windows(n, dev), dct4_twiddles(n, dev)
    pcm = torch.empty((b, c, n), dtype=torch.float32, device=dev)
    new_lap = torch.empty((b, c, n // 2), dtype=torch.float32, device=dev)
    last_ss = torch.empty((b,), dtype=torch.int32, device=dev)
    _launch("ulcx_imdct",
            (coefs, lap, window_ctrl, prev_last_ss, tables, win, tw, pcm, new_lap, last_ss),
            (b, c, n, g["threads"], tables.numel(), win.numel(), tw.shape[0], g["shared"]), dev)
    return pcm, new_lap, last_ss
