"""Batched forward lapped transform (port of ``ulcx.codec.transform_batched``).

Window patterns only ever use subblocks of four size classes N, N/2,
N/4, N/8 at fixed offsets: 15 candidate subblocks in all. Every
candidate of every class is transformed for the whole batch (one
matrix product per class), with per-candidate boundary overlaps from
static tables, and each stream then takes, per coefficient, the class
its pattern uses. The inverse belongs to the decode slice.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ulcx_torch.ops.dct import dct4_dst4
from ulcx_torch.ops.mdct import mdct_fold, mdst_fold, rise_window
from ulcx_torch.ops.patterns import (
    pattern_subblock_offsets,
    pattern_subblock_sizes,
    pattern_transient_flags,
)
from ulcx_torch.utils.config import CodecConfig

N_CLASSES = 4


def candidate_list():
    """[(class, position)] for all 15 candidate subblocks, ordered by
    class, then by position."""
    return [(c, i) for c in range(N_CLASSES) for i in range(1 << c)]


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
    candidate's class shift [15]."""
    t = {k: torch.from_numpy(v).to(device) for k, v in candidate_tables(block_size).items()}
    t["c_shift"] = torch.tensor([c for c, _ in candidate_list()], dtype=torch.int32, device=device)
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
