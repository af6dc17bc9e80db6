"""The reference's exact noise-run window, ``noise_run_window="gap"``,
against ulcx's scan path (its only path for it).

The window is min(z_r, 527) positions, z_r a candidate's distance to its
next coded position, where the default "segment" window takes the
segment's remainder. No kernel has this mode: the port's p1 and p2 stay
the kernels and both p3 walks run their plain versions' gap mode, which
averages the noise over each candidate's gap from the line prefix sums
``cw``, ``cwy``.

- Walks: from ulcx's ``prepare_fast`` output plus ``cw``/``cwy`` of
  ulcx's ``prepare_block``, sizes of eight counts a block and the bytes
  of one equal ``encode_pass_size`` / ``encode_pass_materialize(...,
  "gap")`` exactly (bs256 stereo, and bs1024); the reference's bisection
  finds ulcx's count. Positions whose gap is shorter than the segment's
  remainder occur, and their noise code differs from the segment
  window's there.
- End to end: ``batch_encode`` against ulcx's in CBR, ABR and VBR:
  window control and coded counts exact, total size within 1 %, round-
  trip SNR within 0.3 dB, no corrupt block.
- Drivers: ``fold_bitstream=2`` and ``encode_stream`` give the block
  loop's bytes; ``use_pallas="off"`` gives "auto"'s; no p3 kernel is
  called. (That "on" refuses gap, as in ulcx, is
  ``test_torch_encode.py::test_gap_refuses_pallas_on``.)
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bench import make_corpus
from test_torch_encode import MODES, _decode_snr, _n_nz_port, _n_nz_ulcx, _signals
from ulcx.analysis.batched import analyze_block_batched as j_analyze
from ulcx.bitstream import encode as jenc
from ulcx.bitstream import fast_encode as jfe
from ulcx.codec.encoder import _cbr_search
from ulcx.codec.encoder import init_carry_batched as j_init
from ulcx.parallel.mesh import batch_encode as j_batch_encode
from ulcx.utils.config import CodecConfig
from ulcx_torch.bitstream import encode_kernels as ek
from ulcx_torch.bitstream import fast_encode as tfe
from ulcx_torch.codec.encoder import encode_stream
from ulcx_torch.parallel.mesh import batch_encode
from ulcx_torch.utils.config import CodecConfig as TCodecConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

C = 2
GAP = dict(rate_hz=44100, n_chan=C, noise_run_window="gap")
KW = dict(GAP, block_size=256)
FRAC = np.array([0.0, 0.05, 0.2, 0.4, 0.6, 0.8, 0.95, 1.0])

# ulcx's scan path, jitted once a shape (the budget is traced)
_j_sizes = jax.jit(jax.vmap(lambda bd, k: jenc.encode_pass_size(bd, k, "gap"), in_axes=(None, 0)))
_j_search = jax.jit(_cbr_search, static_argnums=(3,))


@functools.partial(jax.jit, static_argnums=(2,))
def _j_materialize(bd, k, max_bytes):
    return jenc.encode_pass_materialize(bd, k, max_bytes, "gap")


def _corpus(n, b):
    """[b, 2, 2, n]: eight bs256 streams of test_torch_encode, or b
    corpus streams at other block sizes."""
    return _signals(2) if n == 256 else make_corpus(b, 2, n).astype(np.float32)


@pytest.fixture(scope="module", params=[(256, 8), (1024, 2)], ids=["bs256", "bs1024"])
def walk_inputs(request):
    """ulcx's analysis of the second block of b streams: (block size, the
    ulcx config, the analyzed blocks stacked, the port's FastBlockData
    from ulcx's prepare_fast plus prepare_block's cw and cwy, and each
    block's BlockData)."""
    n, b = request.param
    cfg = CodecConfig(**{**KW, "block_size": n})
    x = _corpus(n, b)
    step = jax.jit(lambda c, blk: j_analyze(c, blk, cfg))
    carry, _ = step(j_init(cfg, b), jnp.asarray(x[:, 0]))
    _, stacked = step(carry, jnp.asarray(x[:, 1]))
    fb = jax.jit(lambda s: jfe.prepare_fast(s, cfg))(stacked)
    bds = [jenc.prepare_block(jax.tree_util.tree_map(lambda v: v[i], stacked), cfg)
           for i in range(b)]
    cw = torch.from_numpy(np.stack([np.asarray(bd.cw) for bd in bds]))
    cwy = torch.from_numpy(np.stack([np.asarray(bd.cwy) for bd in bds]))
    fbt = tfe.FastBlockData(*(torch.from_numpy(np.array(v)) for v in fb), cw=cw, cwy=cwy)
    return n, cfg, stacked, fbt, bds


def _noise_codes(pl, nn):
    """(gap window's noise code, segment window's, mask of the gap
    positions a noise run may start at whose gap ends before the
    segment's remainder) [P, B, 8], from the port's walk state."""
    state = tfe._state(pl, nn, ek.KERNEL_WALKS)
    n_pos = state.shape[0]
    pos = torch.arange(n_pos)[:, None, None]
    ncp, qq = state & ek.NCP_MAX, (state >> 24) & 0x1F
    coded = ((state >> 29) & 1) == 1
    z_r = torch.clamp(ncp - pos, 0, ek.SENT).to(torch.int32)
    seg_rem = (pl.aux & 0xFFFF)[:, :, None]
    gap_pos = ~coded & (z_r < seg_rem) & (z_r >= 16)
    amp = pl.ampn[pos[:, 0, 0] >> 1][:, :, None]
    seg = torch.where(amp > 0, torch.clamp(ek.cq_unsigned(amp * ek._exp2i(qq)), max=8), 0)
    return ek._gap_noise_q(z_r, qq, *pl.gap), seg, gap_pos & (z_r < 527)


def test_walks_match_ulcx_scan(walk_inputs):
    """Sizes of eight counts a block and the bytes of one, against
    encode_pass_size / encode_pass_materialize(..., "gap"); where gaps
    end before the segment's remainder the two windows' noise codes
    differ, and so do bytes."""
    n, cfg, stacked, fbt, bds = walk_inputs
    tcfg = TCodecConfig(**{**KW, "block_size": n})
    max_bytes = 2 * C * n
    n_nz = np.asarray(stacked.n_nz)
    nn = np.round(n_nz[:, None] * FRAC[None]).astype(np.int32)
    got = tfe.total_sizes(fbt, torch.from_numpy(nn), tcfg).numpy()
    n_out = nn[:, 4]
    g_size, g_bytes = tfe.materialize_fast(fbt, torch.from_numpy(n_out), tcfg, max_bytes)

    for i, bd in enumerate(bds):
        np.testing.assert_array_equal(got[i], np.asarray(_j_sizes(bd, jnp.asarray(nn[i]))))
        w_bits, w_bytes = _j_materialize(bd, jnp.int32(n_out[i]), max_bytes)
        assert int(g_size[i]) == int(w_bits)
        nb = int(w_bits) // 8
        assert g_bytes[i, :nb].numpy().tobytes() == np.asarray(w_bytes)[:nb].tobytes()

    gap_q, seg_q, shorter = _noise_codes(tfe.make_planes(fbt), torch.from_numpy(nn))
    assert shorter.any()
    assert (shorter & (gap_q != seg_q)).any()
    seg_cfg = TCodecConfig(**{**KW, "block_size": n, "noise_run_window": "segment"})
    words = [tfe._materialize(tfe.make_planes(f), torch.from_numpy(nn), max_bytes, tfe.walks(c))[1]
             for f, c in ((fbt, tcfg), (fbt._replace(cw=None, cwy=None), seg_cfg))]
    assert not torch.equal(*words)


@pytest.mark.parametrize("kbps", [64.0, 128.0])
def test_bisect_matches_cbr_search(walk_inputs, kbps):
    """The port's bisection in gap mode from ulcx's walk inputs finds
    ulcx's _cbr_search count and gives its bytes."""
    n, cfg, stacked, fbt, bds = walk_inputs
    bcfg = CodecConfig(**{**KW, "block_size": n, "rate_search": "bisect"})
    tcfg = TCodecConfig(**{**KW, "block_size": n, "rate_search": "bisect"})
    max_bytes = 2 * C * n
    budget = int(n * kbps * 1000.0 / 44100.0)
    b = len(bds)
    n_out, size, data = tfe.search_materialize_scan(
        fbt, torch.from_numpy(np.array(stacked.n_nz)), torch.full((b,), budget, dtype=torch.int32),
        tcfg, max_bytes)
    for i, bd in enumerate(bds):
        want_n = int(_j_search(bd, stacked.n_nz[i], jnp.int32(budget), bcfg))
        assert int(n_out[i]) == want_n, i
        want_bits, want_by = _j_materialize(bd, jnp.int32(want_n), max_bytes)
        assert int(size[i]) == int(want_bits)
        nb = int(want_bits) // 8
        assert data[i, :nb].numpy().tobytes() == np.asarray(want_by)[:nb].tobytes()


@pytest.fixture(scope="module")
def x():
    return _signals(3)


@pytest.mark.parametrize("mode", list(MODES))
def test_batch_encode_matches_ulcx(x, mode):
    """The port against ulcx's scan path, end to end."""
    kw = MODES[mode]
    cfg = CodecConfig(**KW)
    want, _ = jax.jit(lambda b: j_batch_encode(b, cfg, mode, **kw))(jnp.asarray(x))
    got, stats = batch_encode(torch.from_numpy(x), TCodecConfig(**KW), mode, device="cpu", **kw)
    w_sizes, w_data = np.asarray(want.size_bits), np.asarray(want.data)
    g_sizes, g_data = got.size_bits.numpy(), got.data.numpy()
    np.testing.assert_array_equal(got.window_ctrl.numpy(), np.asarray(want.window_ctrl))
    np.testing.assert_array_equal(_n_nz_port(x), _n_nz_ulcx(x))
    if mode == "cbr":
        assert (g_sizes <= int(256 * 128.0 * 1000.0 / 44100.0)).all()
    assert abs(int(g_sizes.sum()) - int(w_sizes.sum())) <= 0.01 * int(w_sizes.sum())
    assert int(stats["total_bits"]) == int(g_sizes.sum())
    corrupt, snr = _decode_snr(x, g_sizes, g_data)
    assert not corrupt.any()
    _, snr_ulcx = _decode_snr(x, w_sizes, w_data)
    assert abs(snr - snr_ulcx) <= 0.3, (snr, snr_ulcx)


def test_drivers_give_the_block_loops_bytes(x):
    """fold_bitstream=2 and encode_stream (whole, and in two chained
    calls) give the bytes of the per-block loop; use_pallas="off" gives
    "auto"'s."""
    kw = MODES["abr"]
    xs = torch.from_numpy(x[:4, :2].copy())
    base, _ = batch_encode(xs, TCodecConfig(**KW), "abr", device="cpu", **kw)
    for change in ({"fold_bitstream": 2}, {"use_pallas": "off"}):
        got, _ = batch_encode(xs, TCodecConfig(**KW, **change), "abr", device="cpu", **kw)
        for name in ("size_bits", "data", "window_ctrl"):
            assert torch.equal(getattr(got, name), getattr(base, name)), (change, name)
    one, _ = encode_stream(xs[0], TCodecConfig(**KW), "abr", device="cpu", **kw)
    head, carry = encode_stream(xs[0, :1], TCodecConfig(**KW), "abr", device="cpu", **kw)
    tail, _ = encode_stream(xs[0, 1:], TCodecConfig(**KW), "abr", carry=carry, device="cpu", **kw)
    for name in ("size_bits", "data"):
        assert torch.equal(getattr(one, name), getattr(base, name)[0]), name
        assert torch.equal(torch.cat([getattr(head, name), getattr(tail, name)]),
                           getattr(base, name)[0]), name


def test_no_p3_kernel(monkeypatch, x):
    """A gap block step calls p1 and p2 seven times each (P = 512: the
    scan path's ladder, three rounds of sixteen candidates as two of
    eight, and the count materialized) and neither p3 kernel."""
    counts = dict.fromkeys(ek.Walks._fields, 0)

    def counting(name, fn):
        def call(*a):
            counts[name] += 1
            return fn(*a)
        return call

    monkeypatch.setattr(ek, "KERNEL_WALKS", ek.Walks(
        *(counting(k, f) for k, f in zip(ek.Walks._fields, ek.KERNEL_WALKS))))
    batch_encode(torch.from_numpy(x[:3, :1].copy()), TCodecConfig(**KW), "cbr", device="cpu",
                 **MODES["cbr"])
    assert counts == {"p1": 7, "p2": 7, "p3_size": 0, "p3_materialize": 0}

