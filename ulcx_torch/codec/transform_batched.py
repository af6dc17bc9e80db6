"""Batched lapped transforms (port of ``ulcx.codec.transform_batched``).

Window patterns only ever use subblocks of four size classes N, N/2,
N/4, N/8 at fixed offsets: 15 candidate subblocks in all. Every
candidate of every class is transformed for the whole batch (one
matrix product per class), with per-candidate boundary overlaps from
static tables. The forward transform then takes, per coefficient, the
class each stream's pattern uses; the inverse synthesizes every
candidate and accumulates each under its activity mask. Data-dependent
selects (the lap reshuffle, the last subblock's shift) are index
gathers.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

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
    active candidate [16] and each candidate's next active one [16, 15]."""
    with span("ulcx.build.device_tables"):
        t = {k: torch.from_numpy(v).to(device) for k, v in candidate_tables(block_size).items()}
        t["c_shift"] = torch.tensor([c for c, _ in candidate_list()], dtype=torch.int32, device=device)
        order = torch.from_numpy(_cand_order()).to(device)
        t["first"] = _first_active(t["act"], order)
        t["last"] = _last_active(t["act"], order)
        t["next"] = torch.stack([_next_active(t["act"], order, k) for k in range(order.numel())], 1)
        return t


def boundary_overlaps_batched(window_ctrl, prev_last_ss, next_overlap, cfg: CodecConfig):
    """Per-candidate (o_left, o_right) [B, 15] int32: the overlap
    nominal and clamping rules of reference ulcDecoder.c:233-239 /
    ulcEncoder_BlockTransform.c:161-172 for all candidates at once."""
    n = cfg.block_size
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

        # per coefficient, the class this stream's pattern uses
        cls_map = device_tables(n, samples.device)["cls_coef"][(window_ctrl >> 4).long()]
        idx = cls_map.long()[:, None, :, None].expand(b, c, n, 1)
        mdct = torch.gather(torch.stack(outs_c, dim=-1), -1, idx)[..., 0]
        mdst = torch.gather(torch.stack(outs_s, dim=-1), -1, idx)[..., 0]
        return mdct, mdst


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
    t = device_tables(cfg.block_size, window_ctrl.device)
    return (cfg.block_size >> t["c_shift"][t["last"][(window_ctrl >> 4).long()]]).to(torch.int32)


def block_imdct_batched(coefs, window_ctrl, lap, prev_last_ss, cfg: CodecConfig):
    """Batched inverse: coefs [B, C, N], window_ctrl [B], lap [B, C, N/2],
    prev_last_ss [B] -> (pcm [B, C, N], new_lap [B, C, N/2], last_ss [B]).

    Every candidate of a class is synthesized and windowed at once; the
    candidates' halves are added into the output in candidate order, as
    ulcx adds them (each under its activity mask)."""
    with span("ulcx.decode.imdct"):
        n = cfg.block_size
        h = n // 2
        b, c, _ = coefs.shape
        dev = coefs.device
        t = device_tables(n, dev)
        pat = (window_ctrl >> 4).long()
        act = t["act"][pat] == 1  # [B, 15]
        o_l, _ = boundary_overlaps_batched(window_ctrl, prev_last_ss, torch.full_like(window_ctrl, n), cfg)
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
        last_ss = (n >> t["c_shift"][last_k]).to(torch.int32)
        is_last = last_k[:, None] == torch.arange(act.shape[1], device=dev)  # [B, 15]
        o_r = torch.clamp(o_l.gather(1, t["next"][pat]), max=(n >> t["c_shift"]))  # [B, 15]

        v_last = torch.zeros((b, c, h), dtype=torch.float32, device=dev)
        k = 0
        for cls in range(N_CLASSES):
            ss = n >> cls
            npos = 1 << cls
            cand = slice(k, k + npos)
            v = imdct_halfspec(coefs.reshape(b, c, npos, ss), cfg.transform_for(ss))
            wl = rise_window(ss, o_l[:, cand])  # [B, npos, ss]
            wr = rise_window(ss, o_r[:, cand]).flip(-1)
            w = torch.cat([wl, torch.where(is_last[:, cand, None], 0.0, wr)], dim=-1)
            w = torch.where(act[:, cand, None], w, 0.0)
            y = imdct_expand(v) * w[:, None]  # [B, C, npos, 2ss]
            # frame i starts at h - ss/2 + i*ss: its first half meets frame
            # i-1's second half; the end-of-block frame's second half waits
            # in the lap (v_last)
            a = h - ss // 2
            if npos > 1:
                ext[..., a + ss : a + npos * ss] += y[..., :-1, ss:].reshape(b, c, -1)
            ext[..., a : a + npos * ss] += y[..., :ss].reshape(b, c, -1)
            here = is_last[:, cand]  # [B, npos]
            pick = here.long().argmax(dim=1)[:, None, None, None].expand(b, c, 1, ss // 2)
            vi = torch.gather(v[..., : ss // 2], 2, pick)[:, :, 0]
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
