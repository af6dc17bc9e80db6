"""The port's ops and static tables vs ulcx's.

Inputs come from numpy seeds and go through both packages. Bit-level
ops (fast_log, monotone_i32) and integer tables must be identical; the
float32 matrix products (DCT-IV/DST-IV, EMA) may differ in summation
order only, so they are held to 1e-5 of the block's largest magnitude
(the scanned EMA to ulcx's own 3e-5).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ulcx.bitstream import tables as jtables
from ulcx.codec import transform as jtransform
from ulcx.codec import transform_batched as jtb
from ulcx.ops import dct as jdct
from ulcx.ops import keys as jkeys
from ulcx.ops import mdct as jmdct
from ulcx.ops import patterns as jpatterns
from ulcx.ops import quant as jquant
from ulcx.ops import scanutil as jscan
from ulcx.ops.fastlog import fast_log as jfast_log
from ulcx.utils.config import CodecConfig
from ulcx_torch.bitstream import tables as ttables
from ulcx_torch.codec import transform as ttransform
from ulcx_torch.codec import transform_batched as ttb
from ulcx_torch.ops import dct as tdct
from ulcx_torch.ops import keys as tkeys
from ulcx_torch.ops import mdct as tmdct
from ulcx_torch.ops import patterns as tpatterns
from ulcx_torch.ops import quant as tquant
from ulcx_torch.ops import scanutil as tscan
from ulcx_torch.ops.fastlog import fast_log as tfast_log
from ulcx_torch.utils.config import CodecConfig as TCodecConfig

# summation order of the f32 products differs between XLA and torch
RTOL = 1e-5


def _special_floats(rng):
    """Random magnitudes over the whole f32 range plus the edge cases:
    ±0, ±inf, NaNs of both signs and payloads, denormals, extremes."""
    x = (rng.standard_normal(4000) * 10.0 ** rng.uniform(-40, 38, 4000)).astype(np.float32)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-40, -1e-40,
                         1e-45, 1.1754942e-38, 1.1754944e-38, 3.4028235e38, -3.4028235e38,
                         1.0, 2.0, 0.5], np.float32)
    payload_nans = np.array([0x7FC00001, 0xFFC00001, 0x7F800001], np.uint32).view(np.float32)
    return np.concatenate([x, specials, payload_nans])


def _rel_err(got, want):
    return np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max() / (
        np.abs(np.asarray(want, np.float64)).max() + 1e-30)


def test_fast_log_bit_exact():
    """Positive finite inputs, denormals and zero: same bits as ulcx
    (the polynomial is one rounded f32 operation at a time in both)."""
    x = np.abs(_special_floats(np.random.default_rng(1)))
    x = x[np.isfinite(x)]
    want = np.asarray(jfast_log(jnp.asarray(x))).view(np.uint32)
    got = tfast_log(torch.from_numpy(x)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_monotone_i32_bit_exact():
    f = _special_floats(np.random.default_rng(2))
    want = np.asarray(jkeys.monotone_i32(jnp.asarray(f)))
    got = tkeys.monotone_i32(torch.from_numpy(f)).numpy()
    np.testing.assert_array_equal(got, want)
    # ±0 share a key, every NaN maps to INT32_MIN
    assert got[f.view(np.uint32) == 0x80000000][0] == got[f.view(np.uint32) == 0][0]
    assert (got[np.isnan(f)] == np.iinfo(np.int32).min).all()


@pytest.mark.parametrize("n", [32, 256, 2048])
def test_dct4_dst4_matches(n):
    rng = np.random.default_rng(n)
    xc = rng.standard_normal((3, n)).astype(np.float32)
    xs = rng.standard_normal((3, n)).astype(np.float32)
    jc, js = jdct.dct4_dst4(jnp.asarray(xc), jnp.asarray(xs), "matmul")
    tc, ts = tdct.dct4_dst4(torch.from_numpy(xc), torch.from_numpy(xs), "matmul")
    assert _rel_err(tc, jc) < RTOL
    assert _rel_err(ts, js) < RTOL


def test_windows_and_folds_match():
    rng = np.random.default_rng(3)
    for s in (64, 256):
        for o in (0, 8, s // 2, s):
            want = np.asarray(jmdct.rise_window(s, jnp.int32(o)))
            got = tmdct.rise_window(s, torch.tensor(o)).numpy()
            # sin of the same f32 argument: libm and XLA may differ by an ulp
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
        z = rng.standard_normal((4, 2 * s)).astype(np.float32)
        # the folds are sums of two samples: exact
        np.testing.assert_array_equal(tmdct.mdct_fold(torch.from_numpy(z)).numpy(),
                                      np.asarray(jmdct.mdct_fold(jnp.asarray(z))))
        np.testing.assert_array_equal(tmdct.mdst_fold(torch.from_numpy(z)).numpy(),
                                      np.asarray(jmdct.mdst_fold(jnp.asarray(z))))


@pytest.mark.parametrize("n,chunk", [(256, None), (2048, None), (4096, 1024)])
@pytest.mark.parametrize("reverse", [False, True])
def test_ema_matches(n, chunk, reverse):
    rng = np.random.default_rng(n)
    v = (rng.standard_normal((2, n)) ** 2).astype(np.float32)
    init = rng.uniform(0.0, 2.0, 2).astype(np.float32)
    rate = float(np.exp(-115.0 / 44100.0))
    if chunk is None:
        want = jscan.ema_matmul(jnp.asarray(v), rate, jnp.asarray(init), reverse=reverse)
        got = tscan.ema_matmul(torch.from_numpy(v), rate, torch.from_numpy(init), reverse=reverse)
    else:
        want = jscan.ema_matmul_chunked(jnp.asarray(v), rate, jnp.asarray(init),
                                        reverse=reverse, chunk=chunk)
        got = tscan.ema_matmul_chunked(torch.from_numpy(v), rate, torch.from_numpy(init),
                                       reverse=reverse, chunk=chunk)
    assert _rel_err(got, want) < RTOL


@pytest.mark.parametrize("s", [64, 256])
def test_frame_windows_match(s):
    """fall_window and frame_window against ulcx's at every overlap pair
    (the same sin bound as the rise window), overlaps as ints, as scalar
    tensors and one a row."""
    ovs = (0, 8, s // 2, s)
    for o in ovs:
        want = np.asarray(jmdct.fall_window(s, jnp.int32(o)))
        got = tmdct.fall_window(s, torch.tensor(o)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
    pairs = [(a, b) for a in ovs for b in ovs]
    rows = tmdct.frame_window(s, torch.tensor([a for a, _ in pairs]),
                              torch.tensor([b for _, b in pairs])).numpy()
    for (a, b), row in zip(pairs, rows):
        want = np.asarray(jmdct.frame_window(s, jnp.int32(a), jnp.int32(b)))
        np.testing.assert_allclose(tmdct.frame_window(s, a, b).numpy(), want, rtol=0, atol=2e-7)
        np.testing.assert_allclose(row, want, rtol=0, atol=2e-7)


@pytest.mark.parametrize("backend,s", [("matmul", 64), ("matmul", 512), ("fact", 512),
                                       ("fact", 4096), ("fft", 512), ("fft", 4096)])
def test_mdct_frame_matches(backend, s):
    """mdct_mdst_frame and mdct_frame against ulcx's, within 1e-5 of the
    frame's largest magnitude (test_torch_dct_backends.TOL): one overlap
    pair for all rows as ints, and one a row as tensors (against ulcx's
    call on each row)."""
    rng = np.random.default_rng(s)
    fr = rng.standard_normal((4, 2 * s)).astype(np.float32)
    ol, orr = np.array([s, s // 2, 8, 0]), np.array([8, s, s // 2, s])
    wc, ws = jmdct.mdct_mdst_frame(jnp.asarray(fr), jnp.int32(s // 2), jnp.int32(s), backend)
    gc, gs = tmdct.mdct_mdst_frame(torch.from_numpy(fr), s // 2, s, backend)
    assert _rel_err(gc, wc) < RTOL and _rel_err(gs, ws) < RTOL
    assert _rel_err(tmdct.mdct_frame(torch.from_numpy(fr), s // 2, s, backend), wc) < RTOL
    gc, gs = tmdct.mdct_mdst_frame(torch.from_numpy(fr), torch.from_numpy(ol),
                                   torch.from_numpy(orr), backend)
    gm = tmdct.mdct_frame(torch.from_numpy(fr), torch.from_numpy(ol), torch.from_numpy(orr),
                          backend)
    for i in range(fr.shape[0]):
        wc, ws = jmdct.mdct_mdst_frame(jnp.asarray(fr[i]), jnp.int32(ol[i]), jnp.int32(orr[i]),
                                       backend)
        assert _rel_err(gc[i], wc) < RTOL and _rel_err(gs[i], ws) < RTOL
        assert _rel_err(gm[i], wc) < RTOL


# ulcx's own bound for its associative-scan ema (tests/test_ops.py)
EMA_TOL = 3e-5


@pytest.mark.parametrize("n", [256, 4096])
@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("reverse", [False, True])
def test_ema_scan_matches(n, axis, reverse):
    """ema against ulcx's at three rates, with a scalar and a tensor
    init, within 3e-5 of the largest magnitude."""
    rng = np.random.default_rng(n + 7 * reverse)
    v = (rng.standard_normal((3, n)) ** 2).astype(np.float32)
    if axis == 0:
        v = np.ascontiguousarray(v.T)
    for rate in (float(np.exp(-115.0 / 44100.0)), 0.999, 0.5):
        for init in (np.float32(0.7), rng.uniform(0.0, 2.0, 3).astype(np.float32)):
            want = jscan.ema(jnp.asarray(v), rate, jnp.asarray(init), axis=axis, reverse=reverse)
            got = tscan.ema(torch.from_numpy(v), rate, torch.from_numpy(np.asarray(init)),
                            axis=axis, reverse=reverse)
            assert got.shape == v.shape
            assert _rel_err(got, want) < EMA_TOL, (rate, np.ndim(init))


@pytest.mark.parametrize("n", [256, 2048])
def test_pattern_and_segment_tables_match(n):
    assert list(tpatterns.PATTERN_TABLE) == list(jpatterns.PATTERN_TABLE)
    for p in range(1, 16):
        assert tpatterns.pattern_subblock_sizes(p, n) == jpatterns.pattern_subblock_sizes(p, n)
        assert tpatterns.pattern_subblock_offsets(p, n) == jpatterns.pattern_subblock_offsets(p, n)
        assert tpatterns.pattern_transient_flags(p) == jpatterns.pattern_transient_flags(p)
    for got, want in zip(ttables.segment_tables(n, 2), jtables.segment_tables(n, 2)):
        np.testing.assert_array_equal(got, want)
    tt, jt = ttb.candidate_tables(n), jtb.candidate_tables(n)
    for k in tt:
        np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)


def test_overlap_lookups_match():
    n = 2048
    kw = dict(rate_hz=44100, n_chan=2, block_size=n)
    cfg, tcfg = CodecConfig(**kw), TCodecConfig(**kw)
    rng = np.random.default_rng(4)
    wc = (rng.integers(0, 16, 64) << 4 | rng.integers(0, 16, 64)).astype(np.int32)
    prev = rng.choice([256, 512, 1024, 2048], 64).astype(np.int32)
    nxt = rng.choice([32, 128, 1024, 2048], 64).astype(np.int32)
    wct = torch.from_numpy(wc)
    np.testing.assert_array_equal(ttransform.first_overlap(wct, n).numpy(),
                                  np.asarray(jtransform.first_overlap(jnp.asarray(wc), n)))
    np.testing.assert_array_equal(ttransform.last_subblock_size(wct, n).numpy(),
                                  np.asarray(jtransform.last_subblock_size(jnp.asarray(wc), n)))
    want = jtb.boundary_overlaps_batched(jnp.asarray(wc), jnp.asarray(prev), jnp.asarray(nxt), cfg)
    got = ttb.boundary_overlaps_batched(wct, torch.from_numpy(prev), torch.from_numpy(nxt), tcfg)
    assert ttb.candidate_list() == jtb.candidate_list()  # same candidate order
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_expand_quantizer_bit_exact():
    """Every qi in 0..31, the qi > 26 -> 0 corner included: exact products."""
    qi = np.arange(32, dtype=np.int32)
    want = np.asarray(jquant.expand_quantizer(jnp.asarray(qi)))
    got = tquant.expand_quantizer(torch.from_numpy(qi)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (got[27:] == 0).all() and got[0] == 2.0**-5


@pytest.mark.parametrize("fn", ["unsigned", "signed", "coef"])
def test_companded_quantize_bit_exact(fn):
    """Values scaled by every quantizer 2^(5+qi), qi in 0..31, at and one
    ulp around the rounding boundaries (q - 1/2)^2 + 1/4, and saturating
    values: one correctly rounded sqrt per value on both sides."""
    rng = np.random.default_rng(9)
    q = np.arange(0, 40, dtype=np.float32)
    edges = ((q - 0.5) ** 2 + 0.25).astype(np.float32)
    near = np.concatenate([edges, np.nextafter(edges, 0), np.nextafter(edges, np.inf)])
    coef = (rng.standard_normal(2000) * 10.0 ** rng.uniform(-4, 0, 2000)).astype(np.float32)
    scaled = np.concatenate([(coef[:, None] * 2.0 ** (5 + np.arange(32))).ravel().astype(np.float32),
                             near, -near, np.array([0.0, -0.0, 0.5, 0.25, 3e38, np.inf], np.float32)])
    if fn == "unsigned":
        v = np.abs(scaled)
        want = jquant.companded_quantize_unsigned(jnp.asarray(v))
        got = tquant.companded_quantize_unsigned(torch.from_numpy(v))
    elif fn == "signed":
        want = jquant.companded_quantize(jnp.asarray(scaled))
        got = tquant.companded_quantize(torch.from_numpy(scaled))
    else:
        want = jquant.companded_quantize_coef(jnp.asarray(scaled), 7)
        got = tquant.companded_quantize_coef(torch.from_numpy(scaled), 7)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [32, 256])
def test_imdct_matches(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n)).astype(np.float32)
    v_want = np.asarray(jmdct.imdct_halfspec(jnp.asarray(x), "matmul"))
    v_got = tmdct.imdct_halfspec(torch.from_numpy(x), "matmul").numpy()
    assert _rel_err(v_got, v_want) < RTOL
    # the expansion only moves and negates values: exact
    np.testing.assert_array_equal(tmdct.imdct_expand(torch.from_numpy(v_want)).numpy(),
                                  np.asarray(jmdct.imdct_expand(jnp.asarray(v_want))))


def test_kernel_registry():
    """Every entry point of the kernel library has exactly one wrapper,
    registered under its name less ``ulcx_``, with a plain version; the
    wrappers are the modules' names, and the one launch registry covers
    all nine kernels."""
    from ulcx_torch import _build
    from ulcx_torch.bitstream import decode_kernels as dk
    from ulcx_torch.bitstream import encode_kernels as ek

    names = {e.removeprefix("ulcx_") for e in _build._SIGNATURES}
    assert len(names) == 9 and set(_build.KERNELS) == names
    for name, fn in _build.KERNELS.items():
        module = ek if name in ek.Walks._fields else dk if name in dk.Walks._fields else ttb
        assert getattr(module, name) is fn and fn.__name__ == name
        assert fn.plain is getattr(module, f"{name}_plain")
    assert set(ek.KERNEL_WALKS + dk.KERNEL_WALKS + (ttb.imdct,)) == set(_build.KERNELS.values())
    assert ek.PLAIN_WALKS == tuple(w.plain for w in ek.KERNEL_WALKS)
    assert dk.PLAIN_WALKS == tuple(w.plain for w in dk.KERNEL_WALKS)
    _build.reset_launch_counts()
    assert _build.launch_counts() == dict.fromkeys(names, 0)
    assert _build.launch_counts("p1", "imdct") == {"p1": 0, "imdct": 0}
    seed = torch.tensor([1234567, 7], dtype=torch.int32)
    flags = torch.tensor([[1, 0], [3, 1], [0, 0]], dtype=torch.int32)
    for got, want in zip(dk.rng(flags, seed), dk.rng_plain(flags, seed)):  # CPU: the plain version
        assert torch.equal(got, want)
    assert not any(_build.launch_counts().values())
    with pytest.raises(ValueError, match="several devices"):
        dk.rng(flags, seed.to("meta"))
    assert not _build.kernels_on(TCodecConfig(use_pallas="off"))
    assert _build.kernels_on(TCodecConfig(use_pallas="on")) and _build.kernels_on(TCodecConfig())
