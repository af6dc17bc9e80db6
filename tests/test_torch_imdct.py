"""The inverse transform's fast DCT-IV (``csrc/dct4.cuh``) on the CPU.

No CPU runs the kernel, so ``dct4_plane`` below transcribes its DCT-IV
in numpy: the same float32 twiddle tables (``transform_batched.
dct4_twiddle_table``), the bit-reversed load, the radix-2
decimation-in-time stages in the kernel's order of operations (every
product and sum rounded to float32 on its own, as the kernel's
``__fmul_rn``/``__fadd_rn`` do), the subblocks of a row that skip the
stages longer than they are, and the post-twiddle. It is held against a
float64 DCT-IV and against the dense float32 product the plain path
uses, and the card test (``tests/test_torch_cuda.py``) holds the kernel
to it. The last test shows why one plane of half-spectra serves all four
classes: ``imdct_lap_plain`` reads only the active candidates.

Imports nothing of JAX, so the card test may import ``dct4_plane``.
"""

import numpy as np
import pytest
import torch

from ulcx_torch.codec import transform_batched as tb
from ulcx_torch.ops import dct

F32_EPS = float(np.finfo(np.float32).eps)
# A radix-2 FFT of M points rounds each value through log2(M) butterflies
# and the twiddle products, plus the pre- and post-twiddle: its error is
# of order eps * log2(S) of the row's largest value, on random input
# about a tenth of that (1e-7 to 2e-7 read here at S = 16 to 32768).
# FFT_TOL_EPS_LOG2 eps log2(S) leaves that headroom.
FFT_TOL_EPS_LOG2 = 4
# Against the dense float32 product (``dct4_matmul``, what the plain path
# synthesises with): the bound the repo holds its other fast backends
# (``fact``, ``fft``) to against the dense one, of the block's largest
# magnitude (``ops.dct``, ``chip_smoke.DCT_TOL``).
DENSE_TOL = 1e-5


def _bit_reverse(x, bits):
    out = np.zeros_like(x)
    for k in range(int(bits.max()) if np.size(bits) else 0):
        out |= np.where(k < bits, ((x >> k) & 1) << np.maximum(bits - 1 - k, 0), 0)
    return out


def _cmul(ar, ai, br, bi):
    f = np.float32
    return (f(ar * br) - f(ai * bi)).astype(f), (f(ar * bi) + f(ai * br)).astype(f)


def dct4_plane(x: np.ndarray, classes: np.ndarray) -> np.ndarray:
    """The kernel's DCT-IV of each row's active subblocks: x [R, N]
    float32, classes [R, 8] (each eighth's subblock class, 0 to 3) ->
    [R, N] float32, subblock by subblock at its own offset."""
    r_, n = x.shape
    m_all = n // 2
    log_m = m_all.bit_length() - 1
    table = tb.dct4_twiddle_table(n)
    tr, ti = table[:, 0], table[:, 1]
    p = np.arange(m_all)
    cls = classes[:, p >> (log_m - 3)]  # [R, M]
    ls = log_m - cls
    ms = 1 << ls
    o = p & ~(ms - 1)
    loc = p - o
    rv = _bit_reverse(loc, ls)
    pre = n // 4 + 2 * n - (2 * n >> cls)  # dct4.cuh pre_offset
    rows = np.arange(r_)[:, None]
    # load: x[2p] is Re z[loc], x[2p + 1] Im z[M-1-loc]; z[m] sits at m's bit reverse
    re = np.zeros((r_, m_all), np.float32)
    im = np.zeros((r_, m_all), np.float32)
    re[rows, o + rv] = x[:, 0::2]
    im[rows, o + ms - 1 - rv] = x[:, 1::2]
    # the first pass's pre-twiddle: the value at position o + rv is z[loc]
    w = np.empty((r_, m_all), np.int64)
    w[rows, o + rv] = pre + loc
    re, im = _cmul(re, im, tr[w], ti[w])
    for l in range(1, log_m + 1):  # stage l: blocks of L = 2^l
        h = 1 << (l - 1)
        q = p[(p & h) == 0]
        tw = (q & (h - 1)) << (log_m - l)
        live = ls[:, q] >= l  # a smaller subblock has no stage l
        br, bi = _cmul(re[:, q + h], im[:, q + h], tr[tw], ti[tw])
        ar, ai = re[:, q], im[:, q]
        re[:, q], im[:, q] = np.where(live, ar + br, ar), np.where(live, ai + bi, ai)
        re[:, q + h] = np.where(live, ar - br, re[:, q + h])
        im[:, q + h] = np.where(live, ai - bi, im[:, q + h])
    # post-twiddle: v[2j] = Re T[j], v[S-1-2j] = -Im T[j] at plane 2(o + M-1-j) + 1
    post = pre + ms + loc
    t_re, t_im = _cmul(re, im, tr[post], ti[post])
    out = np.empty((r_, n), np.float32)
    out[:, 0::2] = t_re
    out[rows, 2 * (o + ms - 1 - loc) + 1] = -t_im
    return out


def pattern_classes(window_ctrl: np.ndarray, n: int) -> np.ndarray:
    """[B] window controls -> [B, 8] class of each eighth of the block."""
    cls_coef = tb.candidate_tables(n)["cls_coef"]
    return cls_coef[window_ctrl >> 4][:, :: n // 8]


def _dct4_f64(x):
    """The DCT-IV in float64 through one complex FFT of 2S points:
    sum_n x[n] e^{-i pi (n + 1/2)(k + 1/2) / S} = e^{-i pi (k + 1/2) / (2S)}
    FFT_2S(x[n] e^{-i pi n / (2S)})[k], whose real part it is."""
    s = x.shape[-1]
    k = np.arange(s, dtype=np.float64)
    y = np.fft.fft(x.astype(np.float64) * np.exp(-1j * np.pi * k / (2 * s)), n=2 * s)[..., :s]
    return (y * np.exp(-1j * np.pi * (k + 0.5) / (2 * s))).real


def _fft_tol(s):
    return FFT_TOL_EPS_LOG2 * F32_EPS * np.log2(s)


@pytest.mark.parametrize("s", [16, 32, 64, 128, 256, 512, 1024, 2048, 32768])
def test_kernel_dct4_matches_float64_and_dense(s):
    """One subblock filling the row (a long block), 4 rows (1 at 32768)."""
    rows = 1 if s == 32768 else 4
    x = np.random.default_rng(s).standard_normal((rows, s)).astype(np.float32)
    got = dct4_plane(x, np.zeros((rows, 8), np.int64))
    peak = np.abs(_dct4_f64(x)).max(axis=1, keepdims=True)
    assert (np.abs(got - _dct4_f64(x)) <= _fft_tol(s) * peak).all()
    if s <= 2048:  # the dense basis at 32768 would be 8 GB
        dense = dct.dct4_matmul(torch.from_numpy(x)).numpy()
        assert (np.abs(got - dense) <= DENSE_TOL * peak).all()


@pytest.mark.parametrize("n", [16, 256, 2048])
def test_kernel_dct4_of_every_pattern(n):
    """Every window pattern: each active subblock's own DCT-IV at its own
    offset of the plane."""
    rng = np.random.default_rng(n + 1)
    wc = (np.arange(16) << 4 | rng.integers(0, 8, 16)).astype(np.int32)
    x = rng.standard_normal((16, n)).astype(np.float32)
    got = dct4_plane(x, pattern_classes(wc, n))
    cls_coef = tb.candidate_tables(n)["cls_coef"]
    for row, pat in enumerate(wc >> 4):
        off = 0
        while off < n:
            s = n >> int(cls_coef[pat, off])
            want = _dct4_f64(x[row, off:off + s])
            peak = np.abs(want).max()
            assert (np.abs(got[row, off:off + s] - want) <= _fft_tol(max(s, 2)) * peak).all(), (pat, off)
            off += s
        assert off == n


@pytest.mark.parametrize("n", [16, 2048])
def test_dct4_twiddle_table(n):
    """W_{N/2}^k, then each class's pre- and post-twiddles, float32 from float64."""
    t = tb.dct4_twiddle_table(n)
    assert t.dtype == np.float32 and t.shape == (17 * n // 8, 2)
    got = t[:, 0].astype(np.float64) + 1j * t[:, 1]
    k = np.arange(n // 4)
    np.testing.assert_allclose(got[: n // 4], np.exp(-2j * np.pi * k / (n // 2)), atol=F32_EPS)
    off = n // 4
    for cls in range(4):
        s = n >> cls
        i = np.arange(s // 2)
        np.testing.assert_allclose(got[off:off + s // 2], np.exp(-1j * np.pi * i / s), atol=F32_EPS)
        np.testing.assert_allclose(got[off + s // 2:off + s], np.exp(-1j * np.pi * (i + 0.25) / s),
                                   atol=F32_EPS)
        off += s
    assert off == t.shape[0]
    dev = torch.device("cpu")
    assert torch.equal(tb.dct4_twiddles(n, dev), torch.from_numpy(t))


@pytest.mark.parametrize("n", [16, 256, 2048])
def test_one_plane_of_active_subblocks_serves_every_class(n):
    """``imdct_lap_plain`` on the four class planes equals it on one plane
    that holds only each row's active subblocks (every pattern, scale and
    previous last-subblock size): it reads nothing of an inactive
    candidate, so the kernel's one plane is exact."""
    prev = np.array([0, n, n // 2, n // 4, n // 8], np.int32)
    pat, scale, which = (g.ravel() for g in np.meshgrid(np.arange(16), np.arange(8),
                                                          np.arange(5), indexing="ij"))
    b, c = pat.size, 2
    wc = torch.from_numpy((pat << 4 | scale).astype(np.int32))
    prev_ss = torch.from_numpy(prev[which])
    gen = torch.Generator().manual_seed(n)
    v = [torch.randn(b, c, n, generator=gen) for _ in range(4)]
    lap = torch.randn(b, c, n // 2, generator=gen)
    cls_coef = torch.from_numpy(tb.candidate_tables(n)["cls_coef"]).long()[wc.long() >> 4]
    plane = torch.gather(torch.stack(v, -1), -1, cls_coef[:, None, :, None].expand(b, c, n, 1))[..., 0]
    want = tb.imdct_lap_plain(v, wc, lap, prev_ss)
    got = tb.imdct_lap_plain([plane] * 4, wc, lap, prev_ss)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_imdct_geometry():
    """A CTA a row: 256 threads up to N = 4096, 1024 above; the row's
    padded half-spectra (rounded up to 16 bytes) and its lap in shared
    memory; anything else refused."""
    assert tb.imdct_geometry(8192, 2, 2048) == {"threads": 256, "shared": 8 * 1056 + 4 * 1024}
    assert tb.imdct_geometry(1, 1, 64) == {"threads": 256, "shared": 8 * 34 + 4 * 32}
    assert tb.imdct_geometry(1, 1, 32768) == {"threads": 1024, "shared": 8 * 16896 + 4 * 16384}
    assert tb.imdct_geometry(1, 1, 32768)["shared"] <= 227 * 1024
    for bad in ((0, 2, 256), (1, 0, 256), (1, 1, 8), (1, 1, 384), (1, 1, 65536)):
        with pytest.raises(ValueError):
            tb.imdct_geometry(*bad)
