"""The four encode-pass walks: CUDA kernels and their plain versions.

Port of ``ulcx.bitstream.pallas_encode3``. Each walk has

- a wrapper (``p1``, ``p2``, ``p3_size``, ``p3_materialize``): on a CPU
  tensor it runs the plain version; on a CUDA tensor it launches its
  kernel from ``csrc/encode_walks.cu`` or raises. It checks device,
  dtype, shape and contiguity, allocates the outputs, launches on the
  current stream, and adds one to its ``launches`` counter;
- a plain PyTorch version (``*_plain``) with the same signature: a
  Python loop over positions, vectorized over streams and candidates.
  It is the CPU path and the kernels' oracle on the card.

Layouts: per-position planes [P, B] (stream fastest), line planes
[P/2, B], per-candidate values [B, 8], state planes [P, B, 8], words
[B, 8, n_words]. Keep test: position p is kept for candidate (t, c)
when ``key > t | (key == t & p <= c)``, which equals "stable-descending
importance rank < n" when (t, c) is the n-th entry of the sorted
(key desc, position asc) order (``fast_encode._tc_of``).

Field maps (P <= 32768):
  aux    segment length 16 bits | segment-start bit 16
  thr    qmin(|coef[p]|, 2.5) bits 0-5 | qmin(|coef[p+1]|, 2.5) 6-11 |
         qmin(ampn, 0.5) 12-17 | qmin(hfamp, 0.125) 18-23 | hfok bit 24
  s12    zone quantizer qi 5 bits | split bit 5
  state  next coded position 16 bits | quantizer 16-20 | coded bit 21
"""

from __future__ import annotations

import numpy as np
import torch

from ulcx_torch._build import check as _check
from ulcx_torch._build import launch as _launch
from ulcx_torch._build import on_cpu as _on_cpu
from ulcx_torch.ops.quant import sqrt_rn

N_CAND = 8
SENT = 1 << 20  # "no position" sentinel (> any p)

# Launch geometry of the walk kernels (csrc/encode_walks.cu): a CTA
# walks STREAM_TILE streams x 8 candidates in warp 0 while HELPER_WARPS
# warps fill a ring of STAGES shared-memory stages of CHUNK positions
# each and run the carry-free pre-pass over them.
STREAM_TILE = 4
CHUNK = 128
STAGES = 2
HELPER_WARPS = 7
SMEM_LIMIT = 232_448  # bytes of shared memory one block may take on Hopper

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


def p1_plain(t, c, key, coef, aux):
    """Forward zone scan. t, c [B, 8] i32; key, aux [P, B] i32; coef
    [P, B] f32 -> s12 [P, B, 8] i32 (qi | split << 5). Denormal
    magnitudes count as zero, as on the TPU the reference ran on (it
    flushes them), so a denormal never splits a zone of zeros."""
    n_pos, b = key.shape
    qmin = torch.full((b, N_CAND), 1000.0, device=key.device)
    qmax = torch.full((b, N_CAND), -1000.0, device=key.device)
    s12 = torch.empty((n_pos, b, N_CAND), dtype=_I32, device=key.device)
    for p in range(n_pos):
        a = torch.abs(coef[p])[:, None]
        a = torch.where(a < _FLT_MIN, 0.0, a)  # denormals count as zero
        kept = _kept(key[p][:, None], t, c, p)
        segstart = ((aux[p] >> 16) & 1)[:, None] == 1
        qmin = torch.where(segstart, 1000.0, qmin)
        qmax = torch.where(segstart, -1000.0, qmax)
        nmin = torch.minimum(qmin, a)
        nmax = torch.maximum(qmax, a)
        split = kept & (nmax > nmin * 4.0)
        qmin = torch.where(kept, torch.where(split, a, nmin), qmin)
        qmax = torch.where(kept, torch.where(split, a, nmax), qmax)
        # clip in float before the int cast: log(0) = -inf makes +inf here
        x = torch.floor(_BQ_A - _INV_LN2 * torch.log(torch.clamp(qmax, min=1e-38)))
        s12[p] = torch.clamp(x, 5.0, 31.0).to(_I32) | (split.to(_I32) << 5)
    return s12


def p2_plain(t, c, key, thr, aux, s12):
    """Reverse backfill. thr [P, B] i32, s12 [P, B, 8] -> state [P, B, 8]
    (next coded pos | q << 16 | coded << 21)."""
    n_pos, b = key.shape
    shape = (b, N_CAND)
    dev = key.device
    nk = torch.full(shape, SENT, dtype=_I32, device=dev)
    nk_split = torch.zeros(shape, dtype=_I32, device=dev)
    cur_qi = torch.full(shape, 31, dtype=_I32, device=dev)
    q_next = torch.full(shape, 31, dtype=_I32, device=dev)
    ncp = torch.full(shape, SENT, dtype=_I32, device=dev)
    state = torch.empty((n_pos, b, N_CAND), dtype=_I32, device=dev)
    for p in range(n_pos - 1, -1, -1):
        segdelta = (aux[p] & 0xFFFF)[:, None]
        kept = _kept(key[p][:, None], t, c, p)
        s = s12[p]
        zone_end = kept & ((nk >= SENT) | (nk_split == 1) | (nk >= p + segdelta))
        cur_qi = torch.where(zone_end, s & 0x1F, cur_qi)
        coded = kept & (cur_qi >= (thr[p] & 63)[:, None])
        q_next = torch.where(coded, cur_qi, q_next)
        ncp = torch.where(coded, p, ncp)
        state[p] = torch.clamp(ncp, 0, 0xFFFF) | (q_next << 16) | (coded.to(_I32) << 21)
        nk = torch.where(kept, p, nk)
        nk_split = torch.where(kept, (s >> 5) & 1, nk_split)
    return state


def _p3_walk(aux, state, thr=None, mat=None):
    """Forward emission walk shared by both p3 modes; ``mat`` is None
    (size-only, reads ``thr``) or (coef, ampn, hfamp, hfmeta, hdr,
    n_words). Packing runs in int64 masked to 32 bits, so the u32
    shift register never meets signed overflow."""
    n_pos, b = aux.shape
    dev = aux.device
    shape = (b, N_CAND)
    covered = torch.zeros(shape, dtype=_I32, device=dev)
    prev_q = torch.full(shape, -1, dtype=_I32, device=dev)
    bits = torch.zeros(shape, dtype=_I32, device=dev)
    tail_done = torch.zeros(shape, dtype=torch.bool, device=dev)
    if mat is not None:
        coef, ampn, hfamp, hfmeta, hdr, n_words = mat
        h = hdr.to(torch.int64)[:, None].expand(shape)
        fill = h >> 8
        reg = torch.where(fill == 2, h & 0xFF, h & 0xF)
        wcount = torch.zeros(shape, dtype=torch.int64, device=dev)
        # column n_words absorbs the stores past the buffer
        words = torch.zeros((b, N_CAND, n_words + 1), dtype=torch.int64, device=dev)
    for p in range(n_pos):
        ax = aux[p][:, None]
        segdelta = ax & 0xFFFF
        segstart = ((ax >> 16) & 1) == 1
        srow = state[p]
        ncp = srow & 0xFFFF
        qq = (srow >> 16) & 0x1F
        is_code = ((srow >> 21) & 1) == 1
        is_tail = (ncp - p) >= segdelta
        gp = ~is_code & ~is_tail
        s = qq - 5
        ext_q = (s >= 14).to(_I32)
        z_r = torch.clamp(ncp - p, 0, SENT)
        if mat is not None:
            scale = _exp2i(qq)
            c0 = coef[p][:, None]
            c1 = coef[min(p + 1, n_pos - 1)][:, None]
            qn1 = torch.clamp(cq_unsigned(torch.abs(c0) * scale), max=7)
            qn1 = torch.where(c0 < 0, -qn1, qn1)
            qn2 = torch.clamp(cq_unsigned(torch.abs(c1) * scale), max=7)
            qn2 = torch.where(c1 < 0, -qn2, qn2)
            amp = ampn[p >> 1][:, None]
            nq_est = torch.where(amp > 0, torch.clamp(cq_unsigned(amp * scale), max=8), 0)
            resc_ok = (torch.abs(qn1) > 1) & ((z_r < 2) | (torch.abs(qn2) > 1))
            noise_ok = nq_est > 0
        else:
            th = thr[p][:, None]
            resc_ok = (qq >= (th & 63)) & ((z_r < 2) | (qq >= ((th >> 6) & 63)))
            noise_ok = qq >= ((th >> 12) & 63)
        do_resc = gp & (z_r <= 2) & resc_ok
        do_noise = gp & ~do_resc & (z_r >= 16) & noise_ok
        do_zs = gp & ~do_resc & ~do_noise & (z_r < 33)
        run_n = torch.where(
            do_resc, z_r,
            torch.where(do_noise, torch.clamp(z_r, max=527),
                        torch.where(do_zs, torch.clamp(z_r, max=16), torch.clamp(z_r, max=288))),
        )
        run_cnt = torch.where(do_resc, z_r, _i32(torch.where(do_noise, 4, torch.where(do_zs, 2, 3))))

        prev_q = torch.where(segstart, -1, prev_q)
        tail_done = tail_done & ~segstart
        act = (p >= covered) & (is_code | gp)
        lead = (prev_q >= 0).to(_I32)
        need_q = act & (qq != prev_q)
        q_cnt = torch.where(need_q, 1 + ext_q + lead, 0)
        cnt = torch.where(act, q_cnt + torch.where(is_code, 1, run_cnt), 0)
        new_covered = torch.where(act, torch.where(is_code, p + 1, p + run_n), covered)
        new_prev_q = torch.where(need_q, qq, prev_q)

        tail_ev = ~is_code & is_tail & ~tail_done
        pq_valid = prev_q >= 0
        if mat is not None:
            meta = hfmeta[p >> 1][:, None]
            hfok = (meta >> 8) == 1
            dec_t = meta & 0xFF
            nq_hf = torch.clamp(cq_unsigned(hfamp[p >> 1][:, None] * _exp2i(prev_q) * 4.0), max=16)
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
        tail_done = tail_done | tail_ev
        bits = bits + cnt + cnt_tail

        if mat is not None:
            q_cnt64, cnt64 = q_cnt.to(torch.int64), cnt.to(torch.int64)
            qv0 = torch.where(lead == 1, 0xF, torch.where(ext_q == 1, 0xE, s))
            qv1 = torch.where(lead == 1, torch.where(ext_q == 1, 0xE, s), s - 14)
            qv2 = s - 14
            v_noise = run_n - 16
            v_long = run_n - 33
            t0 = torch.where(
                (act & is_code) | do_resc, qn1 & 0xF,
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
                0xFF | (((nq_hf - 1) & 0xF) << 8) | (((dec_t >> 4) & 0xF) << 12)
                | ((dec_t & 0xF) << 16),
                torch.where(
                    do_stop,
                    torch.where(pq_valid, 0xF | (0xE << 4) | (0xF << 8), 0xE | (0xF << 4)),
                    torch.clamp(segdelta - 1, 0, 0xF) << 4,
                ),
            ).to(torch.int64)
            pos_packed = torch.where(
                tail_ev, torch.where(cnt_tail > 0, tail_packed, 0), packed
            )
            full = reg | ((pos_packed << (4 * fill)) & _U32_MASK)
            residue = torch.where(fill == 0, 0, pos_packed >> (32 - 4 * fill))
            newfill = fill + (cnt + cnt_tail).to(torch.int64)
            crossed = newfill >= 8
            slot = torch.where(crossed & (wcount < n_words), wcount, n_words)
            words.scatter_(2, slot[..., None], full[..., None])
            reg = torch.where(crossed, residue, full)
            fill = newfill & 7
            wcount = wcount + crossed.to(torch.int64)
        covered = new_covered
        prev_q = new_prev_q
    if mat is None:
        return bits
    slot = torch.where(wcount < n_words, wcount, n_words)
    words.scatter_(2, slot[..., None], reg[..., None])
    return bits, _wrap_i32(words[..., :n_words]), _wrap_i32(reg), wcount.to(_I32)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """u32 values held in int64 -> the int32 with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(_I32)


def p3_size_plain(thr, aux, state):
    """Size-only emission walk -> bits [B, 8] (nybbles, tail tokens
    included, header excluded)."""
    return _p3_walk(aux, state, thr=thr)


def p3_materialize_plain(coef, ampn, hfamp, hfmeta, aux, state, hdr, n_words: int):
    """Materializing emission walk. coef [P, B] f32; ampn, hfamp [P/2, B]
    f32; hfmeta [P/2, B] i32; hdr [B] i32 (header nybbles | count << 8).
    Returns (bits [B, 8], words [B, 8, n_words] with the final partial
    word at index fwc and zeros after, freg [B, 8], fwc [B, 8])."""
    return _p3_walk(aux, state, mat=(coef, ampn, hfamp, hfmeta, hdr, n_words))


# --- wrappers ---------------------------------------------------------------


def p1(t, c, key, coef, aux):
    """Forward zone scan (replaces pallas_encode3._p1) -> s12 [P, B, 8]."""
    if _on_cpu(t, c, key, coef, aux):
        return p1_plain(t, c, key, coef, aux)
    n_pos, b = key.shape
    for name, x, dt, shp in (("t", t, _I32, (b, N_CAND)), ("c", c, _I32, (b, N_CAND)),
                             ("key", key, _I32, (n_pos, b)), ("coef", coef, torch.float32, (n_pos, b)),
                             ("aux", aux, _I32, (n_pos, b))):
        _check(name, x, dt, shp)
    s12 = torch.empty((n_pos, b, N_CAND), dtype=_I32, device=key.device)
    _launch("ulcx_p1", (t, c, key, coef, aux, s12), (b, n_pos, *_geometry_ints("p1", n_pos, b)),
            key.device)
    p1.launches += 1
    return s12


def p2(t, c, key, thr, aux, s12):
    """Reverse backfill (replaces pallas_encode3._p2) -> state [P, B, 8]."""
    if _on_cpu(t, c, key, thr, aux, s12):
        return p2_plain(t, c, key, thr, aux, s12)
    n_pos, b = key.shape
    for name, x, dt, shp in (("t", t, _I32, (b, N_CAND)), ("c", c, _I32, (b, N_CAND)),
                             ("key", key, _I32, (n_pos, b)), ("thr", thr, _I32, (n_pos, b)),
                             ("aux", aux, _I32, (n_pos, b)), ("s12", s12, _I32, (n_pos, b, N_CAND))):
        _check(name, x, dt, shp)
    _check_aligned("s12", s12)
    state = torch.empty((n_pos, b, N_CAND), dtype=_I32, device=key.device)
    _launch("ulcx_p2", (t, c, key, thr, aux, s12, state),
            (b, n_pos, *_geometry_ints("p2", n_pos, b)), key.device)
    p2.launches += 1
    return state


def p3_size(thr, aux, state):
    """Size-only emission walk (replaces pallas_encode3._p3, size mode)
    -> bits [B, 8]."""
    if _on_cpu(thr, aux, state):
        return p3_size_plain(thr, aux, state)
    n_pos, b = aux.shape
    for name, x, dt, shp in (("thr", thr, _I32, (n_pos, b)), ("aux", aux, _I32, (n_pos, b)),
                             ("state", state, _I32, (n_pos, b, N_CAND))):
        _check(name, x, dt, shp)
    _check_aligned("state", state)
    bits = torch.empty((b, N_CAND), dtype=_I32, device=aux.device)
    _launch("ulcx_p3_size", (thr, aux, state, bits),
            (b, n_pos, *_geometry_ints("p3_size", n_pos, b)), aux.device)
    p3_size.launches += 1
    return bits


def p3_materialize(coef, ampn, hfamp, hfmeta, aux, state, hdr, n_words: int):
    """Materializing emission walk (replaces pallas_encode3._p3,
    materialize mode) -> (bits, words, freg, fwc); see
    ``p3_materialize_plain``."""
    if _on_cpu(coef, ampn, hfamp, hfmeta, aux, state, hdr):
        return p3_materialize_plain(coef, ampn, hfamp, hfmeta, aux, state, hdr, n_words)
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
    p3_materialize.launches += 1
    return bits, words, freg, fwc


KERNELS = (p1, p2, p3_size, p3_materialize)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
