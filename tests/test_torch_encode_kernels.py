"""The port's plain encode walks vs ulcx's Pallas kernels (interpret mode).

Both sides read the same planes, built by ulcx's own prepare_fast and
_v3_planes from tests/test_encode_pass.synth_block blocks (bs256
stereo, P = 512), and every output must match bit for bit: the walks
are integer state machines, and their few float steps (log for the zone
quantizer, sqrt for companding) are exact or far from rounding
boundaries on these inputs.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from test_encode_pass import C, CFG, N, synth_block
from ulcx.bitstream import fast_encode as jfe
from ulcx.bitstream import pallas_encode3 as pe3
from ulcx_torch.bitstream import encode_kernels as ek
from ulcx_torch.bitstream import fast_encode as tfe
from ulcx_torch.utils.config import CodecConfig as TCodecConfig

P = C * N
TCFG = TCodecConfig(rate_hz=44100, n_chan=C, block_size=N)  # CFG's, for the port
B = 8
# every window pattern test_pallas_encode.py lists, plus one more
WCS = [0x10, 0x28, 0x59, 0xFB, 0x3A, 0x6C, 0x8B, 0x10]


def _blocks(seed):
    rng = np.random.default_rng(seed)
    blks = []
    for i, wc in enumerate(WCS):
        blk, coef, _, _ = synth_block(rng, wc, sparsity=float(rng.uniform(0.2, 0.8)))
        if i == 1:
            # zero and denormal coefficients (the zone quantizer's log
            # sees max(0 or denormal, 1e-38))
            m = np.asarray(blk.mdct).copy().reshape(-1)
            m[::7] = 0.0
            m[3::11] = np.float32(1e-40)
            blk = blk._replace(mdct=jnp.asarray(m.reshape(C, N)))
        if i == 7:
            blk = blk._replace(mdct=jnp.zeros((C, N), jnp.float32))
        blks.append(blk)
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *blks)


def _counts(seed):
    """[B, 8] candidate counts, including nn <= 0 and nn = P."""
    rng = np.random.default_rng(seed + 1)
    nn = rng.integers(1, P, (B, 8)).astype(np.int32)
    nn[:, 0] = 0
    nn[0, 1] = -3
    nn[:, 7] = P
    nn[2, 6] = P - 1
    return nn


def _lanes(x):
    """[G=1, P, 1, 128] (or [G, P, 8, 128]) lane plane -> port layout."""
    x = np.asarray(x)
    if x.shape[2] == 1:
        return torch.from_numpy(np.ascontiguousarray(x[0, :, 0, :B]))  # [P, B]
    return torch.from_numpy(np.ascontiguousarray(x[0, :, :, :B].transpose(0, 2, 1)))  # [P, B, 8]


def _same(got, want):
    """Identical int32 planes (dtype included: the kernels write int32)."""
    assert got.dtype == want.dtype == torch.int32, (got.dtype, want.dtype)
    assert torch.equal(got, want)


def _cands(x):
    """[G=1, 8, 128] -> [B, 8]."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)[0, :, :B].T))


def _port_state(state):
    """ulcx's state word (next coded position 16 bits, 0xFFFF for none |
    q << 16 | coded << 21; P <= 32768) -> the port's, field by field
    (24 bits, NCP_MAX for none | q << 24 | coded << 29)."""
    ncp = state & 0xFFFF
    ncp = torch.where(ncp == 0xFFFF, ek.NCP_MAX, ncp)
    return (ncp | (((state >> 16) & 0x1F) << 24) | (((state >> 21) & 1) << 29)).to(torch.int32)


def _jax_p1(t, c, key, coef, aux):
    """ulcx's _p1 pallas_call alone (p12_call runs it fused with _p2)."""
    in_spec, _, _, chunk_spec, _, whole = pe3._specs(P)
    return pl.pallas_call(
        functools.partial(pe3._p1, unroll=1),
        grid=(1, P // pe3.CHUNK),
        in_specs=[whole, whole, in_spec, in_spec, in_spec],
        out_specs=chunk_spec,
        out_shape=jax.ShapeDtypeStruct((1, P, pe3.SUBC, pe3.LAN), jnp.int32),
        scratch_shapes=[pltpu.VMEM((pe3.SUBC, pe3.LAN), jnp.float32)] * 2,
        interpret=True,
    )(t, c, key, coef, aux)


@functools.lru_cache(maxsize=None)
def _case(seed):
    """Reference planes and outputs of ulcx's kernels for one batch."""
    fb = jfe._pad128(jfe.prepare_fast(_blocks(seed), CFG))
    pl3 = jfe._v3_planes(fb, interpret=True)
    nn = _counts(seed)
    nn_l = np.zeros((1, 8, pe3.LAN), np.int32)
    nn_l[0, :, :B] = nn.T
    t_l, c_l = jfe._tc_of(pl3, jnp.asarray(nn_l))
    s12 = _jax_p1(t_l, c_l, pl3.key_l, pl3.coef_l, pl3.aux_l)
    state = pe3.p12_call(t_l, c_l, pl3.key_l, pl3.coef_l, pl3.thr_l, pl3.aux_l, P, True)
    (bits_size,) = pe3.p3_call(None, pl3.thr_l, None, pl3.aux_l, None, None, state, None,
                               P, False, True)
    mat = pe3.p3_call(pl3.coef_l, None, pl3.ampn_l, pl3.aux_l, pl3.hfa_l, pl3.hfm_l, state,
                      pl3.hdr_l, P, True, True)
    planes = dict(
        t=_cands(t_l), c=_cands(c_l), key=_lanes(pl3.key_l), coef=_lanes(pl3.coef_l),
        thr=_lanes(pl3.thr_l), aux=_lanes(pl3.aux_l), ampn=_lanes(pl3.ampn_l),
        hfamp=_lanes(pl3.hfa_l), hfmeta=_lanes(pl3.hfm_l),
        hdr=torch.from_numpy(np.asarray(pl3.hdr_l)[0, 0, :B].copy()),
    )
    ref = dict(s12=_lanes(s12), state=_lanes(state), bits_size=_cands(bits_size),
               mat=[np.asarray(x) for x in mat])
    return fb, planes, ref


@pytest.mark.parametrize("seed", [0, 1])
def test_p1_p2_match_pallas(seed):
    _, pv, ref = _case(seed)
    s12 = ek.p1(pv["t"], pv["c"], pv["key"], pv["coef"], pv["aux"])
    _same(s12, ref["s12"])
    state = ek.p2(pv["t"], pv["c"], pv["key"], pv["thr"], pv["aux"], s12)
    _same(state, _port_state(ref["state"]))



@pytest.mark.parametrize("streams", [1, 3])
@pytest.mark.parametrize("walk", ["p1", "p2", "p3_size", "p3_materialize"])
def test_plain_walks_in_chunks_match_pallas(monkeypatch, walk, streams):
    """Each plain walk runs the batch in chunks of streams (1, and 3 with
    a ragged last chunk) when its working planes outgrow
    PLAIN_CHUNK_BYTES, and gives what ulcx's kernel gives."""
    _, pv, ref = _case(0)
    entry = 8 * ((P - 1).bit_length() + 1) if walk == "p1" else ek.PLAIN_ENTRY_BYTES[walk]
    rows = P + 1 if walk == "p1" else P
    monkeypatch.setattr(ek, "PLAIN_CHUNK_BYTES", streams * rows * 8 * entry)
    state = _port_state(ref["state"])
    if walk == "p1":
        _same(ek.p1_plain(pv["t"], pv["c"], pv["key"], pv["coef"], pv["aux"]), ref["s12"])
    elif walk == "p2":
        _same(ek.p2_plain(pv["t"], pv["c"], pv["key"], pv["thr"], pv["aux"], ref["s12"]), state)
    elif walk == "p3_size":
        _same(ek.p3_size_plain(pv["thr"], pv["aux"], state), ref["bits_size"])
    else:
        n_words = 2 * P // 4
        bits, words, freg, fwc = ek.p3_materialize_plain(
            pv["coef"], pv["ampn"], pv["hfamp"], pv["hfmeta"], pv["aux"], state, pv["hdr"], n_words)
        jbits, _, _, jfreg, jfwc = ref["mat"]
        for got, want in ((bits, jbits), (freg, jfreg), (fwc, jfwc)):
            _same(got, _cands(want))
        np.testing.assert_array_equal(words.numpy(), _ref_words(ref["mat"], n_words))


@pytest.mark.parametrize("seed", [0, 1])
def test_p3_size_matches_pallas(seed):
    _, pv, ref = _case(seed)
    bits = ek.p3_size(pv["thr"], pv["aux"], _port_state(ref["state"]))
    _same(bits, ref["bits_size"])


def _ref_words(mat, n_words):
    """ulcx's positional (word, widx) planes compacted per (stream,
    candidate) into [B, 8, n_words], the final register at index fwc."""
    _, word, widx, freg, fwc = mat
    out = np.zeros((B, 8, n_words), np.int32)
    for b in range(B):
        for j in range(8):
            valid = widx[0, :, j, b] < 2**30
            idx, w = widx[0, valid, j, b], word[0, valid, j, b]
            assert (idx == np.arange(len(idx))).all()  # position order
            w = w[:n_words]
            out[b, j, : len(w)] = w
            if fwc[0, j, b] < n_words:
                out[b, j, fwc[0, j, b]] = freg[0, j, b]
    return out


@pytest.mark.parametrize("seed,n_words", [(0, 2 * P // 4), (1, 2 * P // 4), (0, 6)])
def test_p3_materialize_matches_pallas(seed, n_words):
    _, pv, ref = _case(seed)
    bits, words, freg, fwc = ek.p3_materialize(
        pv["coef"], pv["ampn"], pv["hfamp"], pv["hfmeta"], pv["aux"], _port_state(ref["state"]),
        pv["hdr"],
        n_words,
    )
    jbits, _, _, jfreg, jfwc = ref["mat"]
    _same(bits, _cands(jbits))
    _same(freg, _cands(jfreg))
    _same(fwc, _cands(jfwc))
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy(), _ref_words(ref["mat"], n_words))
    # packed words fill all 32 bits: the u32 register's top bit is used
    assert (words.numpy() < 0).any()


def test_thr_plane_matches(rng):
    fb, pv, _ = _case(0)
    thr = tfe.thr_plane(*(torch.from_numpy(np.asarray(x)[:B])
                          for x in (fb.coef, fb.amp_noise, fb.amp_lin, fb.hf_meta)))
    assert torch.equal(thr.t().contiguous(), pv["thr"])


def test_materialize_and_sizes_match_ulcx():
    """Port total_sizes / materialize_fast on ulcx's FastBlockData ==
    ulcx's own (sizes and every byte)."""
    fb_pad, _, _ = _case(0)
    fbj = jax.tree_util.tree_map(lambda x: x[:B], fb_pad)
    fbt = tfe.FastBlockData(*(torch.from_numpy(np.array(x)) for x in fbj))
    nn = _counts(0)
    want = np.asarray(jfe.total_sizes(fbj, jnp.asarray(nn), CFG, interpret=True))
    got = tfe.total_sizes(fbt, torch.from_numpy(nn), TCFG)
    np.testing.assert_array_equal(got.numpy(), want)

    n_out = nn[:, 3]
    ws, wb = jfe.materialize_fast(fbj, jnp.asarray(n_out), CFG, 2 * C * N, interpret=True)
    gs, gb = tfe.materialize_fast(fbt, torch.from_numpy(n_out), TCFG, 2 * C * N)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))


def test_cuda_wrappers_refuse_bad_inputs():
    """Wrapper checks run before any launch: a plane on another device
    or of the wrong dtype is refused (no silent CPU fallback)."""
    _, pv, _ = _case(0)
    with pytest.raises(ValueError):
        ek.p1(pv["t"], pv["c"], pv["key"], pv["coef"], pv["aux"].to("meta"))
    with pytest.raises(ValueError):
        ek.p3_size(pv["thr"], pv["aux"], torch.empty(P, B, 8, dtype=torch.int32, device="meta"))


def _served_positions():
    """Every P = n_chan * block_size <= 32768, and P past it up to the
    top of the envelope, 255 channels x 32768 (the kernel path serves
    every P)."""
    small = {c * (256 << s) for s in range(8) for c in range(1, 256) if c * (256 << s) <= 32768}
    return sorted(small | {2 * 32768, 3 * 32768, 40 * 4096, 255 * 32768})


@pytest.mark.parametrize("b", [1, 13, 128, 512, 2048])
def test_walk_geometry_covers_once(b):
    """The walk kernels' launch geometry: shared memory within Hopper's
    per-block limit, and the stream tiles, position chunks and
    half-height line tiles each cover their range exactly once (so the
    tiles cover every (stream, position) once)."""
    streams = np.zeros(b, np.int64)
    for b0, ns in ek.stream_tiles(b):
        assert 1 <= ns <= ek.STREAM_TILE and b0 % ek.STREAM_TILE == 0
        streams[b0:b0 + ns] += 1
    assert (streams == 1).all()
    for n_pos in _served_positions():
        for kind in ("p1", "p2", "p3_size", "p3_materialize"):
            g = ek.walk_geometry(kind, n_pos, b)
            assert g["smem"] <= ek.SMEM_LIMIT, (kind, g["smem"])
            assert g["grid"] == len(ek.stream_tiles(b)) and g["threads"] % 32 == 0
            pos = np.zeros(n_pos, np.int64)
            lines = np.zeros(n_pos // 2, np.int64)
            chunks = ek.walk_chunks(n_pos, g["chunk"], kind == "p2")
            for lo, hi in chunks:
                assert 0 < hi - lo <= g["chunk"]
                pos[lo:hi] += 1
                if kind != "p2":  # forward: lines start on a position pair
                    assert lo % 2 == 0
                    lines[lo // 2:(hi + 1) // 2] += 1
            assert (pos == 1).all(), (kind, n_pos)
            if kind != "p2":
                assert (lines == 1).all(), (kind, n_pos)
            order = [lo for lo, _ in chunks]
            assert order == sorted(order, reverse=kind == "p2")


def test_walk_smem_matches_layout():
    """The byte counts the entry points check, by hand at CHUNK = 128:
    per position 4 streams x 4 bytes per [P, B] plane and 32 walkers x 4
    bytes per [P, B, 8] plane, pre-pass or walker word, two stages; p1
    and p2 then hold t and c of the 32 walkers."""
    assert ek.walk_smem_bytes("p1", 128) == 2 * 128 * (4 * 16 + 2 * 128) + 256
    assert ek.walk_smem_bytes("p2", 128) == 2 * 128 * (3 * 16 + 3 * 128) + 256
    assert ek.walk_smem_bytes("p3_size", 128) == 2 * 128 * (2 * 16 + 2 * 128)
    assert ek.walk_smem_bytes("p3_materialize", 128) == 2 * (
        128 * (16 + 128 + 2 * 128) + 129 * 16 + 4 * 64 * 16)
    with pytest.raises(ValueError):
        ek.walk_smem_bytes("p4", 128)
