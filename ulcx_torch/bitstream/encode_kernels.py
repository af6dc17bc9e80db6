"""The four encode-pass walks: CUDA kernels and their plain versions.

Port of ``ulcx.bitstream.pallas_encode3``. Each walk has

- a wrapper (``p1``, ``p2``, ``p3_size``, ``p3_materialize``),
  registered by ``_build.kernel``: on a CPU tensor it runs the plain
  version; on a CUDA tensor it checks dtype, shape and contiguity,
  allocates the outputs and launches its kernel from
  ``csrc/encode_walks.cu`` on the current stream, or raises;
- a plain PyTorch version (``*_plain``) with the same signature, on
  whatever device its inputs lie: whole-plane ops, no loop over
  positions (p1 a binary search over sparse tables of window minima and
  maxima, p2 suffix minima of indices, p3 pointer doubling and prefix
  sums), exact equivalents of the serial walks. It is the CPU path, the
  ``use_pallas="off"`` path, and the kernels' oracle on the card; both
  p3 walks also have a mode no kernel has, the gap noise window
  (``p3_size_gap_plain``, ``p3_materialize_gap_plain``). Their
  working planes take tens to hundreds of bytes a (position, stream,
  candidate) (PLAIN_ENTRY_BYTES; p1's sparse tables 8 (ceil(log2 P) + 1)),
  so each runs the batch in chunks of streams whose planes fit
  PLAIN_CHUNK_BYTES (``_by_streams``).

Layouts: per-position planes [P, B] (stream fastest), line planes
[P/2, B], per-candidate values [B, 8], state planes [P, B, 8], words
[B, 8, n_words]. Keep test: position p is kept for candidate (t, c)
when ``key > t | (key == t & p <= c)``, which equals "stable-descending
importance rank < n" when (t, c) is the n-th entry of the sorted
(key desc, position asc) order (``fast_encode._tc_of``).

Field maps (any P = n_chan * block_size <= 255 * 32768 < 2^23):
  aux    segment length 16 bits (a segment lies in one channel, so it
         is at most the block size, 32768) | segment-start bit 16
  thr    qmin(|coef[p]|, 2.5) bits 0-5 | qmin(|coef[p+1]|, 2.5) 6-11 |
         qmin(ampn, 0.5) 12-17 | qmin(hfamp, 0.125) 18-23 | hfok bit 24
  s12    zone quantizer qi 5 bits | split bit 5
  state  next coded position 24 bits (NCP_MAX: none) | quantizer 24-28 |
         coded bit 29
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ulcx_torch._build import check as _check
from ulcx_torch._build import kernel
from ulcx_torch._build import launch as _launch
from ulcx_torch.ops.quant import sqrt_rn

N_CAND = 8
SENT = 1 << 24  # "no position" sentinel (> any p: P <= 255 * 32768 < 2^23)
NCP_MAX = SENT - 1  # SENT clamped into the state word's 24-bit field

# Launch geometry of the walk kernels (csrc/encode_walks.cu): a CTA
# walks STREAM_TILE streams x 8 candidates in warp 0 while HELPER_WARPS
# warps fill a ring of STAGES shared-memory stages of CHUNK positions
# each and run the carry-free pre-pass over them.
STREAM_TILE = 4
CHUNK = 128
STAGES = 2
HELPER_WARPS = 7
SMEM_LIMIT = 232_448  # bytes of shared memory one block may take on Hopper
PLAIN_CHUNK_BYTES = 1 << 30  # a plain walk's working planes for one chunk of streams
# peak bytes a (position, stream, candidate) of p2, p3 size and p3 materialize's
# whole-plane ops: 56, 91 and 256 measured at P = 65,536 (devtools/torch_plain_memory.py);
# the p3 walks' gap mode peaks no higher (chip_smoke.py phase 15)
PLAIN_ENTRY_BYTES = {"p2": 64, "p3_size": 96, "p3_materialize": 256}

# BuildQuantizer constants (reference ulcEncoder_Encode.c:50-87)
_BQ_A = float(np.float32(float.fromhex("0x1.657006p2")))
_INV_LN2 = float(np.float32(float.fromhex("0x1.715476p0")))
_FLT_MIN = 2.0**-126  # smallest normal f32
_INT_MAX_F = 2147483520.0  # largest f32 below 2^31
_I32 = torch.int32
_U32_MASK = 0xFFFFFFFF


def cq_unsigned(v: torch.Tensor) -> torch.Tensor:
    """Companded quantize |v| (reference ulcHelper.h:50-65). Clipped in
    float before the int cast, so +inf saturates as in XLA and PTX (a
    CPU ``.to(int32)`` of inf gives INT32_MIN)."""
    q = torch.floor(0.5 + sqrt_rn(torch.clamp(v - 0.25, min=0.0)))
    return torch.where(v >= 0.5, torch.clamp(q, max=_INT_MAX_F), 0.0).to(_I32)


def _exp2i(q: torch.Tensor) -> torch.Tensor:
    """2^q as f32 for q clipped to [0, 31], by exponent-field construction."""
    return ((torch.clamp(q, 0, 31) + 127) << 23).to(_I32).view(torch.float32)


def _i32(x: torch.Tensor) -> torch.Tensor:
    """A where() of two Python ints is int64; the walks count in int32."""
    return x.to(_I32)


def _kept(key_p, t, c, p: int):
    return (key_p > t) | ((key_p == t) & (p <= c))


# --- launch geometry --------------------------------------------------------


def _arr(n: int) -> int:
    """Bytes of n 4-byte elements rounded up to 16 (``arr`` in the .cu)."""
    return -(-4 * n // 16) * 16


def walk_smem_bytes(kind: str, chunk: int) -> int:
    """Dynamic shared memory of one walk CTA: STAGES stages of the
    layouts ``p1_layout``/``p2_layout``/``p3_layout`` in
    csrc/encode_walks.cu, which the entry points check against this
    number."""
    rows, cands, half = _arr(chunk * STREAM_TILE), _arr(chunk * STREAM_TILE * N_CAND), chunk // 2
    if kind == "p1":  # key, coef, aux, segment starts | pre-pass words | walker words; then t, c
        return STAGES * (4 * rows + 2 * cands) + _arr(2 * STREAM_TILE * N_CAND)
    if kind == "p2":  # key, thr, aux, s12 | pre-pass words | state rows; then t, c
        return STAGES * (3 * rows + 3 * cands) + _arr(2 * STREAM_TILE * N_CAND)
    if kind == "p3_size":  # aux, thr, state | pre-pass words
        return STAGES * (2 * rows + 2 * cands)
    if kind == "p3_materialize":
        # aux, state, coef (+1 look-ahead row), ampn, hfamp, hfmeta | two
        # pre-pass words, HF amplitudes
        lines = _arr(half * STREAM_TILE)
        return STAGES * (rows + cands + _arr((chunk + 1) * STREAM_TILE) + 3 * lines
                         + 2 * cands + lines)
    raise ValueError(f"no walk kind {kind!r}")


def walk_geometry(kind: str, n_pos: int, b: int, chunk: int = CHUNK,
                  helper_warps: int = HELPER_WARPS) -> dict:
    """Launch geometry of the walk kernels at P = n_pos, B = b: the
    stream tile, chunk length, ring stages, threads and shared-memory
    bytes per CTA, and the grid (CTAs ``stream_tiles``, each walking the
    chunks ``walk_chunks``)."""
    if n_pos < 1 or b < 1:
        raise ValueError(f"empty walk: P={n_pos}, B={b}")
    return {
        "streams": STREAM_TILE, "chunk": chunk, "stages": STAGES,
        "threads": 32 * (1 + helper_warps), "smem": walk_smem_bytes(kind, chunk),
        "grid": -(-b // STREAM_TILE),
    }


def walk_chunks(n_pos: int, chunk: int, reverse: bool) -> list:
    """[(lo, hi)] position ranges of the chunks in walk order; p2 walks
    from high p to low (``chunk_span`` in csrc/walk_ring.cuh)."""
    n = -(-n_pos // chunk)
    if reverse:
        return [(max(n_pos - (k + 1) * chunk, 0), n_pos - k * chunk) for k in range(n)]
    return [(k * chunk, min((k + 1) * chunk, n_pos)) for k in range(n)]


def stream_tiles(b: int) -> list:
    """[(b0, ns)] streams of each CTA: b0 = blockIdx * STREAM_TILE."""
    return [(b0, min(STREAM_TILE, b - b0)) for b0 in range(0, b, STREAM_TILE)]


def _geometry_ints(kind: str, n_pos: int, b: int) -> tuple:
    g = walk_geometry(kind, n_pos, b)
    return g["chunk"], g["threads"], g["smem"]


def _check_aligned(name: str, x) -> None:
    """The [P, B, 8] planes move in 16-byte copies."""
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


# --- plain versions ---------------------------------------------------------


def _positions(n_pos: int, device) -> torch.Tensor:
    """[P, 1, 1] int64 position indices."""
    return torch.arange(n_pos, device=device)[:, None, None]


def _next_index(cond: torch.Tensor, strict: bool = False) -> torch.Tensor:
    """Along dim 0: the smallest index q >= p (q > p when ``strict``)
    where ``cond`` holds, SENT where there is none."""
    pos = torch.arange(cond.shape[0], device=cond.device).view(-1, *([1] * (cond.dim() - 1)))
    nxt = torch.where(cond, pos, SENT).flip(0).cummin(0).values.flip(0)
    if strict:
        nxt = torch.cat([nxt[1:], torch.full_like(nxt[:1], SENT)])
    return nxt


def _at(values: torch.Tensor, idx: torch.Tensor, default: int) -> torch.Tensor:
    """values[idx[p], ...] along dim 0; ``default`` where idx is SENT."""
    got = values.expand_as(idx).gather(0, torch.clamp(idx, max=values.shape[0] - 1))
    return torch.where(idx < SENT, got, default)


def _last_before(cond: torch.Tensor, seg0: torch.Tensor) -> torch.Tensor:
    """Along dim 0: the largest index q < p with q >= seg0[p] where
    ``cond`` holds, -1 where there is none."""
    pos = torch.arange(cond.shape[0], device=cond.device).view(-1, *([1] * (cond.dim() - 1)))
    last = torch.where(cond, pos, -1).cummax(0).values
    last = torch.cat([torch.full_like(last[:1], -1), last[:-1]])
    return torch.where(last >= seg0, last, -1)


def _window_tables(x: torch.Tensor, op, neutral: float) -> list:
    """Sparse tables along dim 0: level k holds ``op`` over the window
    [p, p + 2^k) (windows past the end padded with ``neutral``), each
    with one more neutral row at index P."""
    n_pos = x.shape[0]
    pad = torch.full_like(x[:1], neutral)
    tabs = [torch.cat([x, pad])]
    k = 1
    while k < n_pos:
        t = tabs[-1]
        tabs.append(torch.cat([op(t[:-k], t[k:]), pad.expand(k, *x.shape[1:])]))
        k *= 2
    return tabs


def _chain(first: torch.Tensor, succ: torch.Tensor) -> torch.Tensor:
    """Nodes [P, B, 8] of the chains from the roots ``first`` [R, B, 8]
    along ``succ`` [P, B, 8] (strictly increasing; P is the sink, where
    a chain ends). Pointer doubling: after the round with jump length k,
    ``on`` holds each chain's first 2k nodes."""
    n_pos = succ.shape[0]
    nxt = torch.cat([succ, torch.full_like(succ[:1], n_pos)])  # [P + 1, B, 8]
    on = torch.zeros_like(nxt, dtype=_I32).scatter_(0, first, 1)
    k = 1
    while k <= n_pos:
        on = on | (torch.zeros_like(on).scatter_add_(0, nxt, on) > 0).to(_I32)
        nxt = nxt.gather(0, nxt)
        k *= 2
    return on[:n_pos] == 1


def _by_streams(fn, args, axes, n_pos: int, entry_bytes: int, out_axis: int):
    """fn(*args) on chunks of the batch whose [P, chunk, 8] working planes
    take at most PLAIN_CHUNK_BYTES at ``entry_bytes`` an entry (streams
    are independent). ``axes``: each argument's stream axis (None: passed
    whole); the outputs are joined along ``out_axis``."""
    b = next(a.shape[ax] for a, ax in zip(args, axes) if ax is not None)
    step = max(1, PLAIN_CHUNK_BYTES // (n_pos * N_CAND * entry_bytes))
    if step >= b:
        return fn(*args)
    parts = [fn(*(a if ax is None else a.narrow(ax, i, min(step, b - i)).contiguous()
                  for a, ax in zip(args, axes)))
             for i in range(0, b, step)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(xs, out_axis) for xs in zip(*parts))
    return torch.cat(parts, out_axis)


def p1_plain(t, c, key, coef, aux):
    """Forward zone scan. t, c [B, 8] i32; key, aux [P, B] i32; coef
    [P, B] f32 -> s12 [P, B, 8] i32 (qi | split << 5). Denormal
    magnitudes count as zero, as on the TPU the reference ran on (it
    flushes them), so a denormal never splits a zone of zeros. Chunks
    of streams are sized by the sparse tables, 2 x 4 bytes an entry a
    level."""
    n_pos = key.shape[0]
    levels = max(1, (n_pos - 1).bit_length()) + 1
    return _by_streams(_p1_zones, (t, c, key, coef, aux), (0, 0, 1, 1, 1), n_pos + 1,
                       8 * levels, 1)


def _p1_zones(t, c, key, coef, aux):
    """``p1_plain`` on one chunk of streams.

    The serial scan keeps the running minimum and maximum of the kept
    magnitudes since the zone opened (at a segment start, from 1000 and
    -1000; at a split, from the splitting value) and splits where the
    maximum passes 4x the minimum. Both only grow apart, so the split
    that closes a zone is the first position where the zone's window of
    kept values has max > 4 min: a binary search over sparse tables of
    window minima and maxima finds it for every position at once, and
    pointer doubling marks the splits reached from the segment starts.
    Each position's maximum is then a window maximum from its zone's
    start."""
    n_pos = key.shape[0]
    pos = _positions(n_pos, key.device)
    kept = _kept(key[:, :, None], t[None], c[None], pos)
    a = torch.abs(coef)
    a = torch.where(a < _FLT_MIN, 0.0, a)[:, :, None]  # denormals count as zero
    inf = float("inf")
    tmin = _window_tables(torch.where(kept, a, inf), torch.minimum, inf)
    tmax = _window_tables(torch.where(kept, a, -inf), torch.maximum, -inf)
    starts = (((aux >> 16) & 1) == 1) | (pos[:, :, 0] == 0)  # [P, B]
    seg0 = torch.where(starts, pos[:, :, 0], 0).cummax(0).values[:, :, None]
    seg_end = torch.clamp(_next_index(starts, strict=True), max=n_pos)[:, :, None]

    def first_split(mn, mx):
        """From every p as a zone's start with (mn, mx): the first q >= p
        before the segment's end whose value splits the zone, else the
        segment's end."""
        cur, end = pos.expand_as(kept), seg_end
        mn, mx = mn.expand_as(kept), mx.expand_as(kept)
        for k in range(len(tmin) - 1, -1, -1):
            nm = torch.minimum(mn, tmin[k].gather(0, cur))
            nx = torch.maximum(mx, tmax[k].gather(0, cur))
            ok = (cur + (1 << k) <= end) & ~(nx > nm * 4.0)
            cur = torch.where(ok, cur + (1 << k), cur)
            mn, mx = torch.where(ok, nm, mn), torch.where(ok, nx, mx)
        return torch.where(cur < end, cur, n_pos)

    ones = torch.ones_like(a[:1, :, :1])
    at_start = first_split(1000.0 * ones, -1000.0 * ones)  # a segment's first zone
    roots = torch.where(starts[:, :, None], at_start, n_pos)
    split = _chain(roots, first_split(inf * ones, -inf * ones))
    del tmin
    # each position's zone: the last split at or before it in its segment,
    # else the segment's start, which also counts the initial -1000
    z = torch.where(split, pos, -1).cummax(0).values
    opened = z >= seg0
    lo = torch.where(opened, z, seg0.expand_as(z))
    lvl = torch.floor(torch.log2((pos - lo + 1).to(torch.float64))).to(torch.int64)
    hi = pos - (1 << lvl) + 1
    qmax = torch.full(lvl.shape, -inf, dtype=a.dtype, device=a.device)
    for k, tab in enumerate(tmax):  # the window [lo, pos] as two of length 2^lvl
        at = lvl == k
        qmax = torch.where(at, torch.maximum(tab.gather(0, lo), tab.gather(0, hi)), qmax)
    qmax = torch.where(opened, qmax, torch.clamp(qmax, min=-1000.0))
    # clip in float before the int cast: log(0) = -inf makes +inf here
    x = torch.floor(_BQ_A - _INV_LN2 * torch.log(torch.clamp(qmax, min=1e-38)))
    return torch.clamp(x, 5.0, 31.0).to(_I32) | (split.to(_I32) << 5)


def p2_plain(t, c, key, thr, aux, s12):
    """Reverse backfill (``_p2_backfill``) on chunks of streams."""
    return _by_streams(_p2_backfill, (t, c, key, thr, aux, s12), (0, 0, 1, 1, 1, 1),
                       key.shape[0], PLAIN_ENTRY_BYTES["p2"], 1)


def _p2_backfill(t, c, key, thr, aux, s12):
    """Reverse backfill. thr [P, B] i32, s12 [P, B, 8] -> state [P, B, 8]
    (next coded pos, NCP_MAX for none | q << 24 | coded << 29).

    Each carried value of the backward walk is a lookup at the nearest
    position ahead where a condition holds (a suffix minimum of indices):
    the next kept position decides where a zone ends, the nearest zone
    end at or after p gives p's quantizer, and the nearest coded position
    the next coded position and its quantizer."""
    n_pos = key.shape[0]
    pos = _positions(n_pos, key.device)
    kept = _kept(key[:, :, None], t[None], c[None], pos)
    segdelta = (aux & 0xFFFF)[:, :, None]
    nk = _next_index(kept, strict=True)
    nk_split = _at((s12 >> 5) & 1, nk, 0)
    zone_end = kept & ((nk >= SENT) | (nk_split == 1) | (nk >= pos + segdelta))
    cur_qi = _at(s12 & 0x1F, _next_index(zone_end), 31)
    coded = kept & (cur_qi >= (thr & 63)[:, :, None])
    ncp = _next_index(coded)
    q_next = _at(cur_qi, ncp, 31).to(torch.int64)
    return (torch.clamp(ncp, max=NCP_MAX) | (q_next << 24) | (coded.to(torch.int64) << 29)).to(_I32)


def _active(actable: torch.Tensor, adv: torch.Tensor) -> torch.Tensor:
    """The emission walk's active positions [P, B, 8]: the first actable
    position, then from each active p the first actable q >= p + adv[p]
    (adv >= 1)."""
    n_pos = actable.shape[0]
    first = torch.clamp(_next_index(actable), max=n_pos)
    first = torch.cat([first, torch.full_like(first[:1], n_pos)])  # first[P] = the sink
    return _chain(first[:1], first.gather(0, torch.clamp(_positions(n_pos, adv.device) + adv,
                                                          max=n_pos)))


def _gap_noise_q(z_r, qq, cw, cwy):
    """The noise-fill code [P, B, 8] of every (position, stream,
    candidate) over the reference's run window, min(z_r, 527) positions
    (``noise_run_window="gap"``, ulcx/bitstream/encode.py:248-261): the
    amplitude exp(S_wy / S_w) of the lines [p >> 1, b), S from the
    exclusive line prefix sums cw, cwy [P/2 + 1, B], scaled by the
    quantizer of the next coded position, its code capped at 8 and 0
    where S_wy is 0."""
    n_pos = z_r.shape[0]
    pos = _positions(n_pos, z_r.device)
    a = pos >> 1
    n = (torch.clamp(z_r, max=527) + (pos & 1) + 1) >> 1
    b = torch.clamp(a + n, 0, cw.shape[0] - 1)

    def span(c):
        return c[:, :, None].expand(-1, -1, N_CAND).gather(0, b) - c[a[:, 0, 0]][:, :, None]

    s_w, s_wy = span(cw), span(cwy)
    amp = torch.exp(s_wy / torch.where(s_w > 0, s_w, 1.0))
    return _i32(torch.where(s_wy != 0, torch.clamp(cq_unsigned(amp * _exp2i(qq)), max=8), 0))


def _p3_walk(aux, state, thr=None, mat=None, gap=()):
    """The emission walk shared by both p3 modes; ``mat`` is None
    (size-only, reads ``thr``) or (coef, ampn, hfamp, hfmeta, hdr,
    n_words). ``gap`` is () for the segment noise window, whose noise
    test size-only reads from ``thr`` and materialize from ``ampn``, or
    the line prefix sums (cw, cwy) of the gap window, whose noise code
    both modes compute per candidate (``_gap_noise_q``).

    Whole-plane ops, no loop over positions: every position's event
    (its class, run length and nybbles) depends on the state plane only;
    the positions the walk acts on are a chain (each act covers its run)
    that pointer doubling marks (``_active``); the carried quantizer is
    the one of the last act in the segment, the segment's tail token
    fires at its first tail position, and the packed words are the
    nybbles laid out at the exclusive prefix sums of the counts.
    Packing runs in int64, so the u32 words never meet signed overflow."""
    n_pos, b = aux.shape
    dev = aux.device
    pos = _positions(n_pos, dev)
    line = torch.arange(n_pos, device=dev) >> 1
    ax = aux[:, :, None]
    segdelta = ax & 0xFFFF
    seg0 = torch.where(((aux >> 16) & 1) == 1, pos[:, :, 0], 0).cummax(0).values[:, :, None]
    ncp = state & NCP_MAX
    qq = (state >> 24) & 0x1F
    is_code = ((state >> 29) & 1) == 1
    is_tail = (ncp - pos) >= segdelta
    gp = ~is_code & ~is_tail
    s = qq - 5
    ext_q = (s >= 14).to(_I32)
    z_r = torch.clamp(ncp - pos, 0, SENT).to(_I32)
    if mat is not None:
        coef, ampn, hfamp, hfmeta, hdr, n_words = mat
        scale = _exp2i(qq)
        c0 = coef[:, :, None]
        c1 = torch.cat([coef[1:], coef[-1:]])[:, :, None]
        qn1 = torch.clamp(cq_unsigned(torch.abs(c0) * scale), max=7)
        qn1 = torch.where(c0 < 0, -qn1, qn1)
        qn2 = torch.clamp(cq_unsigned(torch.abs(c1) * scale), max=7)
        qn2 = torch.where(c1 < 0, -qn2, qn2)
        if gap:
            nq_est = _gap_noise_q(z_r, qq, *gap)
        else:
            amp = ampn[line][:, :, None]
            nq_est = torch.where(amp > 0, torch.clamp(cq_unsigned(amp * scale), max=8), 0)
        resc_ok = (torch.abs(qn1) > 1) & ((z_r < 2) | (torch.abs(qn2) > 1))
        noise_ok = nq_est > 0
    else:
        th = thr[:, :, None]
        resc_ok = (qq >= (th & 63)) & ((z_r < 2) | (qq >= ((th >> 6) & 63)))
        noise_ok = _gap_noise_q(z_r, qq, *gap) > 0 if gap else qq >= ((th >> 12) & 63)
    do_resc = gp & (z_r <= 2) & resc_ok
    do_noise = gp & ~do_resc & (z_r >= 16) & noise_ok
    do_zs = gp & ~do_resc & ~do_noise & (z_r < 33)
    run_n = torch.where(
        do_resc, z_r,
        torch.where(do_noise, torch.clamp(z_r, max=527),
                    torch.where(do_zs, torch.clamp(z_r, max=16), torch.clamp(z_r, max=288))),
    )
    run_cnt = torch.where(do_resc, z_r, _i32(torch.where(do_noise, 4, torch.where(do_zs, 2, 3))))

    act = _active(is_code | gp, torch.where(is_code, 1, run_n).to(torch.int64))
    last = _last_before(act, seg0)  # the segment's previous act sets the carried quantizer
    prev_q = torch.where(last >= 0, qq.gather(0, torch.clamp(last, min=0)), -1)
    lead = (prev_q >= 0).to(_I32)
    need_q = act & (qq != prev_q)
    q_cnt = _i32(torch.where(need_q, 1 + ext_q + lead, 0))
    cnt = _i32(torch.where(act, q_cnt + torch.where(is_code, 1, run_cnt), 0))

    tail_pos = ~is_code & is_tail
    tail_ev = tail_pos & (_last_before(tail_pos, seg0) < 0)  # the segment's first
    pq_valid = prev_q >= 0
    if mat is not None:
        meta = hfmeta[line][:, :, None]
        hfok = (meta >> 8) == 1
        dec_t = meta & 0xFF
        nq_hf = torch.clamp(cq_unsigned(hfamp[line][:, :, None] * _exp2i(prev_q) * 4.0), max=16)
        hf_amp_ok = nq_hf > 0
    else:
        hfok = ((th >> 24) & 1) == 1
        hf_amp_ok = prev_q >= ((th >> 18) & 63)
    do_hf = tail_ev & pq_valid & (segdelta >= 16) & hfok & hf_amp_ok
    do_stop = tail_ev & (segdelta > 4) & ~do_hf
    do_zt = tail_ev & (segdelta > 0) & (segdelta <= 4)
    cnt_tail = _i32(torch.where(
        do_hf, 5, torch.where(do_stop, torch.where(pq_valid, 3, 2), torch.where(do_zt, 2, 0))
    ))
    bits = torch.sum(cnt + cnt_tail, 0, dtype=_I32)
    if mat is None:
        return bits

    q_cnt64, cnt64 = q_cnt.to(torch.int64), cnt.to(torch.int64)
    qv0 = torch.where(lead == 1, 0xF, torch.where(ext_q == 1, 0xE, s))
    qv1 = torch.where(lead == 1, torch.where(ext_q == 1, 0xE, s), s - 14)
    qv2 = s - 14
    v_noise = run_n - 16
    v_long = run_n - 33
    t0 = torch.where(
        is_code | do_resc, qn1 & 0xF,
        torch.where(do_noise, 0x8, torch.where(do_zs, 0x0, 0x1)),
    )
    t1 = torch.where(
        do_resc, qn2 & 0xF,
        torch.where(do_noise, (v_noise >> 5) & 0xF,
                    torch.where(do_zs, run_n - 1, (v_long >> 4) & 0xF)),
    )
    t2 = torch.where(do_noise, (v_noise >> 1) & 0xF, v_long & 0xF)
    t3 = ((v_noise & 1) | ((nq_est - 1) << 1)) & 0xF
    qpart = ((qv0 & 0xF) | ((qv1 & 0xF) << 4) | ((qv2 & 0xF) << 8)).to(torch.int64)
    tpart = ((t0 & 0xF) | ((t1 & 0xF) << 4) | ((t2 & 0xF) << 8)
             | ((t3 & 0xF) << 12)).to(torch.int64)
    packed = (
        (qpart & ((1 << (4 * q_cnt64)) - 1)) | (tpart << (4 * q_cnt64))
    ) & ((1 << (4 * cnt64)) - 1)
    tail_packed = torch.where(
        do_hf,
        0xFF | (((nq_hf - 1) & 0xF) << 8) | (((dec_t >> 4) & 0xF) << 12) | ((dec_t & 0xF) << 16),
        torch.where(
            do_stop,
            torch.where(pq_valid, 0xF | (0xE << 4) | (0xF << 8), 0xE | (0xF << 4)),
            torch.clamp(segdelta - 1, 0, 0xF) << 4,
        ),
    ).to(torch.int64)
    pos_packed = torch.where(tail_ev, torch.where(cnt_tail > 0, tail_packed, 0), packed)

    # the header's nybbles start word 0; each position's nybbles follow at
    # the exclusive prefix sum of the counts (at most 7, so they span at
    # most two words)
    h = hdr.to(torch.int64)[None, :, None]
    fill0 = h >> 8
    n_nyb = (cnt + cnt_tail).to(torch.int64)
    off = fill0 + torch.cumsum(n_nyb, 0) - n_nyb
    shifted = pos_packed << (4 * (off & 7))
    low, high = shifted & _U32_MASK, shifted >> 32
    w_lo = off >> 3
    fwc = (fill0[0] + n_nyb.sum(0)) >> 3  # [B, 8] completed words
    freg = (torch.where(w_lo == fwc, low, 0) + torch.where(w_lo + 1 == fwc, high, 0)).sum(0)
    reg0 = torch.where(fill0 == 2, h & 0xFF, h & 0xF)[0].expand(b, N_CAND)
    freg = freg + torch.where(fwc == 0, reg0, 0)
    # column n_words absorbs the nybbles past the buffer
    words = torch.zeros((b, N_CAND, n_words + 1), dtype=torch.int64, device=dev)
    words[:, :, 0] = reg0 if n_words > 0 else 0

    def slot(w):
        return torch.clamp(w, max=n_words).permute(1, 2, 0)

    words.scatter_add_(2, slot(w_lo), low.permute(1, 2, 0))
    words.scatter_add_(2, slot(w_lo + 1), high.permute(1, 2, 0))
    return bits, _wrap_i32(words[..., :n_words]), _wrap_i32(freg), fwc.to(_I32)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """u32 values held in int64 -> the int32 with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(_I32)


def p3_size_plain(thr, aux, state):
    """Size-only emission walk -> bits [B, 8] (nybbles, tail tokens
    included, header excluded)."""
    return _by_streams(lambda thr, aux, state: _p3_walk(aux, state, thr=thr), (thr, aux, state),
                       (1, 1, 1), aux.shape[0], PLAIN_ENTRY_BYTES["p3_size"], 0)


def p3_materialize_plain(coef, ampn, hfamp, hfmeta, aux, state, hdr, n_words: int):
    """Materializing emission walk. coef [P, B] f32; ampn, hfamp [P/2, B]
    f32; hfmeta [P/2, B] i32; hdr [B] i32 (header nybbles | count << 8).
    Returns (bits [B, 8], words [B, 8, n_words] with the final partial
    word at index fwc and zeros after, freg [B, 8], fwc [B, 8])."""
    def walk(coef, ampn, hfamp, hfmeta, aux, state, hdr):
        return _p3_walk(aux, state, mat=(coef, ampn, hfamp, hfmeta, hdr, n_words))

    return _by_streams(walk, (coef, ampn, hfamp, hfmeta, aux, state, hdr), (1, 1, 1, 1, 1, 1, 0),
                       aux.shape[0], PLAIN_ENTRY_BYTES["p3_materialize"], 0)


# --- wrappers ---------------------------------------------------------------


@kernel(p1_plain)
def p1(t, c, key, coef, aux):
    """Forward zone scan (replaces pallas_encode3._p1) -> s12 [P, B, 8]."""
    n_pos, b = key.shape
    for name, x, dt, shp in (("t", t, _I32, (b, N_CAND)), ("c", c, _I32, (b, N_CAND)),
                             ("key", key, _I32, (n_pos, b)), ("coef", coef, torch.float32, (n_pos, b)),
                             ("aux", aux, _I32, (n_pos, b))):
        _check(name, x, dt, shp)
    s12 = torch.empty((n_pos, b, N_CAND), dtype=_I32, device=key.device)
    _launch("ulcx_p1", (t, c, key, coef, aux, s12), (b, n_pos, *_geometry_ints("p1", n_pos, b)),
            key.device)
    return s12


@kernel(p2_plain)
def p2(t, c, key, thr, aux, s12):
    """Reverse backfill (replaces pallas_encode3._p2) -> state [P, B, 8]."""
    n_pos, b = key.shape
    for name, x, dt, shp in (("t", t, _I32, (b, N_CAND)), ("c", c, _I32, (b, N_CAND)),
                             ("key", key, _I32, (n_pos, b)), ("thr", thr, _I32, (n_pos, b)),
                             ("aux", aux, _I32, (n_pos, b)), ("s12", s12, _I32, (n_pos, b, N_CAND))):
        _check(name, x, dt, shp)
    _check_aligned("s12", s12)
    state = torch.empty((n_pos, b, N_CAND), dtype=_I32, device=key.device)
    _launch("ulcx_p2", (t, c, key, thr, aux, s12, state),
            (b, n_pos, *_geometry_ints("p2", n_pos, b)), key.device)
    return state


@kernel(p3_size_plain)
def p3_size(thr, aux, state):
    """Size-only emission walk (replaces pallas_encode3._p3, size mode)
    -> bits [B, 8]."""
    n_pos, b = aux.shape
    for name, x, dt, shp in (("thr", thr, _I32, (n_pos, b)), ("aux", aux, _I32, (n_pos, b)),
                             ("state", state, _I32, (n_pos, b, N_CAND))):
        _check(name, x, dt, shp)
    _check_aligned("state", state)
    bits = torch.empty((b, N_CAND), dtype=_I32, device=aux.device)
    _launch("ulcx_p3_size", (thr, aux, state, bits),
            (b, n_pos, *_geometry_ints("p3_size", n_pos, b)), aux.device)
    return bits


@kernel(p3_materialize_plain)
def p3_materialize(coef, ampn, hfamp, hfmeta, aux, state, hdr, n_words: int):
    """Materializing emission walk (replaces pallas_encode3._p3,
    materialize mode) -> (bits, words, freg, fwc); see
    ``p3_materialize_plain``."""
    n_pos, b = aux.shape
    if n_pos % 2:
        raise ValueError(f"P must be even, got {n_pos}")
    for name, x, dt, shp in (("coef", coef, torch.float32, (n_pos, b)),
                             ("ampn", ampn, torch.float32, (n_pos // 2, b)),
                             ("hfamp", hfamp, torch.float32, (n_pos // 2, b)),
                             ("hfmeta", hfmeta, _I32, (n_pos // 2, b)),
                             ("aux", aux, _I32, (n_pos, b)),
                             ("state", state, _I32, (n_pos, b, N_CAND)), ("hdr", hdr, _I32, (b,))):
        _check(name, x, dt, shp)
    _check_aligned("state", state)
    dev = aux.device
    bits = torch.empty((b, N_CAND), dtype=_I32, device=dev)
    words = torch.zeros((b, N_CAND, n_words), dtype=_I32, device=dev)
    freg = torch.empty((b, N_CAND), dtype=_I32, device=dev)
    fwc = torch.empty((b, N_CAND), dtype=_I32, device=dev)
    _launch(
        "ulcx_p3_materialize",
        (aux, state, coef, ampn, hfamp, hfmeta, hdr, bits, words, freg, fwc),
        (b, n_pos, n_words, *_geometry_ints("p3_materialize", n_pos, b)), dev,
    )
    return bits, words, freg, fwc


def p3_size_gap_plain(thr, aux, state, cw, cwy):
    """``p3_size_plain`` with the gap noise window: cw, cwy [P/2 + 1, B]
    f32 exclusive line prefix sums of the noise weights w and w*y.
    No kernel has this mode: like ulcx's scan path, it runs as
    whole-plane ops on any device."""
    return _by_streams(lambda thr, aux, state, cw, cwy: _p3_walk(aux, state, thr=thr,
                                                                 gap=(cw, cwy)),
                       (thr, aux, state, cw, cwy), (1, 1, 1, 1, 1), aux.shape[0],
                       PLAIN_ENTRY_BYTES["p3_size"], 0)


def p3_materialize_gap_plain(coef, ampn, hfamp, hfmeta, aux, state, hdr, n_words: int, cw, cwy):
    """``p3_materialize_plain`` with the gap noise window (cw, cwy as in
    ``p3_size_gap_plain``); ``ampn`` is not read."""
    def walk(coef, hfamp, hfmeta, aux, state, hdr, cw, cwy):
        return _p3_walk(aux, state, mat=(coef, None, hfamp, hfmeta, hdr, n_words), gap=(cw, cwy))

    return _by_streams(walk, (coef, hfamp, hfmeta, aux, state, hdr, cw, cwy),
                       (1, 1, 1, 1, 1, 0, 1, 1), aux.shape[0],
                       PLAIN_ENTRY_BYTES["p3_materialize"], 0)


class Walks(NamedTuple):
    """One implementation of each walk, called alike."""

    p1: Callable
    p2: Callable
    p3_size: Callable
    p3_materialize: Callable


KERNEL_WALKS = Walks(p1, p2, p3_size, p3_materialize)  # a CPU tensor runs the plain versions
PLAIN_WALKS = Walks(*(w.plain for w in KERNEL_WALKS))  # on any device
