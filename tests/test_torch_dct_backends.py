"""The port's ``fact`` and ``fft`` transform backends, and what they open:
block sizes above 2048.

Transforms: the same seeded input through ``ulcx.ops.dct`` and
``ulcx_torch.ops.dct`` in each backend, and through a float64 dense
product; every float32 backend keeps ~1e-6 of the block's largest
magnitude, so 1e-5 of it is the bound (ROADMAP A.7). The factorized
backend's constants are built by the same numpy code in both packages
and must be equal exactly.

Large blocks: mono bs4096 (its N=4096 subblock takes ``fact`` under the
default ``transform_backend="auto"``), B=8 streams x T=2 blocks, through
both analyses (decisions exact, MDCT to the transform's tolerance) and
both encoders end to end (ulcx's kernels in interpret mode): total size
within 1 %, round-trip SNR within 0.3 dB.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bench import make_corpus
from ulcx.analysis.batched import analyze_block_batched as j_analyze
from ulcx.codec.encoder import init_carry_batched as j_init
from ulcx.ops import dct as jdct
from ulcx.parallel.mesh import batch_encode as j_batch_encode
from ulcx.utils.config import CodecConfig
from ulcx_torch.analysis.batched import analyze_block_batched as t_analyze
from ulcx_torch.codec.encoder import init_carry_batched as t_init
from ulcx_torch.ops import dct as tdct
from ulcx_torch.parallel.mesh import batch_decode
from ulcx_torch.parallel.mesh import batch_encode as t_batch_encode
from ulcx_torch.utils.config import CodecConfig as TCodecConfig

TOL = 1e-5  # of the block's largest magnitude
SIZES = [64, 512, 4096, 8192]
ROWS = 6


def _dense64(x, fn):
    """x [R, N] through the float64 basis fn(pi/N (n+1/2)(k+1/2)), built
    1024 columns at a time."""
    n = x.shape[-1]
    k = np.arange(n, dtype=np.float64) + 0.5
    out = np.empty(x.shape, np.float64)
    for c0 in range(0, n, 1024):
        out[:, c0 : c0 + 1024] = x.astype(np.float64) @ fn(np.pi / n * np.outer(k, k[c0 : c0 + 1024]))
    return out


def _close(got, want):
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max(axis=-1, keepdims=True)
    return (np.abs(np.asarray(got, np.float64) - want) <= TOL * scale).all()


@pytest.fixture(scope="module")
def inputs():
    return {n: np.random.default_rng(n).standard_normal((2, ROWS, n)).astype(np.float32)
            for n in SIZES}


@pytest.fixture(scope="module")
def dense(inputs):
    return {n: (_dense64(x[0], np.cos), _dense64(x[1], np.sin)) for n, x in inputs.items()}


@pytest.mark.parametrize("kind", ["dct4", "dst4", "pair"])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("backend", ["fact", "fft"])
def test_backend_matches_ulcx_and_dense(inputs, dense, backend, n, kind):
    xc, xs = inputs[n]
    want_c, want_s = dense[n]
    tc, ts = torch.from_numpy(xc), torch.from_numpy(xs)
    if kind == "pair":
        got = tdct.dct4_dst4(tc, ts, backend)
        ref = jdct.dct4_dst4(jnp.asarray(xc), jnp.asarray(xs), backend)
        wants = (want_c, want_s)
    elif kind == "dct4":
        got, ref, wants = (tdct.dct4(tc, backend),), (jdct.dct4(jnp.asarray(xc), backend),), (want_c,)
    else:
        got, ref, wants = (tdct.dst4(ts, backend),), (jdct.dst4(jnp.asarray(xs), backend),), (want_s,)
    for g, r, w in zip(got, ref, wants):
        assert g.dtype == torch.float32 and g.shape == (ROWS, n) and g.is_contiguous()
        assert _close(g.numpy(), np.asarray(r))  # ulcx, same backend
        assert _close(g.numpy(), w)  # the transform's definition


@pytest.mark.parametrize("n", [64, 512, 4096])
@pytest.mark.parametrize("backend", ["fact", "fft"])
def test_backend_matches_port_matmul(inputs, backend, n):
    xc, xs = (torch.from_numpy(a) for a in inputs[n])
    want = tdct.dct4_dst4(xc, xs, "matmul")
    for g, w in zip(tdct.dct4_dst4(xc, xs, backend), want):
        assert _close(g.numpy(), w.numpy())
    assert _close(tdct.dct4(xs, backend).numpy(), tdct.dct4(xs, "matmul").numpy())
    assert _close(tdct.dst4(xc, backend).numpy(), tdct.dst4(xc, "matmul").numpy())


def test_backends_take_leading_axes():
    """Any leading batch axes, as the batched transforms pass them."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 3, 4, 128)).astype(np.float32))
    for backend in ("fact", "fft"):
        c, s = tdct.dct4_dst4(x, x, backend)
        assert c.shape == s.shape == x.shape
        assert _close(c.numpy(), tdct.dct4(x, "matmul").numpy())
        assert _close(s.numpy(), tdct.dst4(x, "matmul").numpy())


@pytest.mark.parametrize("n", [4, 64, 512, 4096, 8192, 32768])
def test_fact_consts_equal_ulcx(n):
    got, want = tdct._fact_consts(n), jdct._fact_consts(n)
    assert got[:2] == want[:2] and got[0] >= got[1] and 2 * got[0] * got[1] == n
    for (gr, gi), (wr, wi) in zip(got[2:], want[2:]):
        assert gr.dtype == gi.dtype == np.float32
        np.testing.assert_array_equal(gr, wr)
        np.testing.assert_array_equal(gi, wi)


def test_fact_refuses_other_lengths():
    for n in (2, 96):
        with pytest.raises(ValueError, match="power of two"):
            tdct.dct4(torch.zeros(1, n), "fact")


# ---------------------------------------------------------------------------
# mono bs4096

N, C, B, T = 4096, 1, 8, 2
KW = dict(rate_hz=44100, n_chan=C, block_size=N, use_pallas="on")
CFG, TCFG = CodecConfig(**KW), TCodecConfig(**KW)  # ulcx's, the port's


@pytest.fixture(scope="module")
def x():
    return np.ascontiguousarray(make_corpus(B, T, N)[:, :, :1])


def test_config_selects_fact_above_matmul_max_n():
    assert [TCFG.transform_for(ss) for ss in TCFG.subblock_sizes] == \
        [CFG.transform_for(ss) for ss in CFG.subblock_sizes] == ["fact", "matmul", "matmul", "matmul"]


def test_analysis_bs4096_matches_ulcx(x):
    step = jax.jit(lambda c, blk: j_analyze(c, blk, CFG))
    jc, tc = j_init(CFG, B), t_init(TCFG, B, "cpu")
    for j in range(T):
        jc, jb = step(jc, jnp.asarray(x[:, j]))
        tc, tb = t_analyze(tc, torch.from_numpy(x[:, j]), TCFG)
        np.testing.assert_array_equal(tb.window_ctrl.numpy(), np.asarray(jb.window_ctrl))
        np.testing.assert_array_equal(tb.n_nz.numpy(), np.asarray(jb.n_nz))
        want = np.asarray(jb.mdct, np.float64)
        # the bound tests/test_torch_analysis.py holds the bs256 transform to
        assert np.abs(tb.mdct.numpy() - want).max() / np.abs(want).max() < 1e-5
    np.testing.assert_array_equal(tc.next_window_ctrl.numpy(), np.asarray(jc.next_window_ctrl))


def _decode_snr(x, sizes, data):
    b, t = sizes.shape
    win = -(-int(sizes.max() // 8) // 64) * 64 + 64
    streams = np.zeros((b, t * win + win + 64), np.uint8)
    for i in range(b):
        off = 0
        for j in range(t):
            nb = int(sizes[i, j]) // 8
            streams[i, off: off + nb] = data[i, j, :nb]
            off += nb
    pcm, bits, corrupt = batch_decode(torch.from_numpy(streams), t, win, TCFG, device="cpu")
    assert ((bits.numpy() + 7) // 8 * 8 == sizes).all()
    want = x[:, : t - 1]
    err = pcm.numpy()[:, 1:] - want
    return corrupt.numpy(), 10 * np.log10((want ** 2).sum() / (err ** 2).sum())


def test_batch_encode_bs4096_matches_ulcx(x):
    want, _ = jax.jit(lambda b: j_batch_encode(b, CFG, "cbr", rate_kbps=96.0))(jnp.asarray(x))
    got, _ = t_batch_encode(torch.from_numpy(x), TCFG, "cbr", rate_kbps=96.0, device="cpu")
    w_sizes, g_sizes = np.asarray(want.size_bits), got.size_bits.numpy()
    np.testing.assert_array_equal(got.window_ctrl.numpy(), np.asarray(want.window_ctrl))
    assert (g_sizes <= int(N * 96.0 * 1000.0 / 44100.0)).all()
    assert abs(int(g_sizes.sum()) - int(w_sizes.sum())) <= 0.01 * int(w_sizes.sum())
    corrupt, snr = _decode_snr(x, g_sizes, got.data.numpy())
    assert not corrupt.any()
    _, snr_ulcx = _decode_snr(x, w_sizes, np.asarray(want.data))
    assert abs(snr - snr_ulcx) <= 0.3, (snr, snr_ulcx)
