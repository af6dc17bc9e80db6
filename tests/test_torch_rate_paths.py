"""The two rate paths off the defaults: ``rate_search="bisect"`` and
``use_pallas="off"``, against ulcx.

``bisect`` is a step-for-step copy of ulcx's ``_cbr_search`` (the
reference's bisection, ulcEncoder.c:98-115) over the walks' size rounds:
from ulcx's own ``prepare_fast`` output it must find the count ulcx's
``_cbr_search(prepare_block(blk), ...)`` finds, and give the bytes of
``encode_pass_materialize`` at that count, exactly (bs256 stereo
``synth_block`` blocks, P = 512). End to end, ulcx honours ``bisect`` on
its scan path: window control and coded counts exact, total size
within 1 % and round-trip SNR within 0.3 dB (eight bs256 streams, CBR
and ABR, both packages on the scan path's plan, ``use_pallas="off"``;
the kernel path's plan ignores ``rate_search``, as ulcx's does).
``use_pallas="off"`` runs the plain walks; the wrappers of the kernels
run the same plain versions on CPU tensors, so on the CPU its bytes and
PCM are identical to the default's wherever both take the same plan
(a batch that is no multiple of 8), and it must not call the wrappers
at all. The walk counts of a block step are (ceil(log2 P) + 2,
ceil(log2 P) + 2, ceil(log2 P) + 1, 1) for bisect, (7, 7, 6, 1) for the
scan path's ladder at P = 512 (three rounds of sixteen candidates, each
two rounds of the walks' eight, and the count materialized) and
(3, 3, 2, 1) for the kernel path's seeded ladder.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_encode_pass import synth_block
from test_torch_encode import MODES, _decode_snr, _n_nz_port, _n_nz_ulcx, _signals
from ulcx.bitstream import encode as jenc
from ulcx.bitstream import fast_encode as jfe
from ulcx.codec.encoder import _cbr_search
from ulcx.parallel.mesh import batch_encode as j_batch_encode
from ulcx.utils.config import CodecConfig
from ulcx_torch.bitstream import encode_kernels as ek
from ulcx_torch.bitstream import fast_encode as tfe
from ulcx_torch.parallel.mesh import batch_decode, batch_encode
from ulcx_torch.utils.config import CodecConfig as TCodecConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, C = 256, 2
P = N * C
MAX_BYTES = 2 * P
KW = dict(rate_hz=44100, n_chan=C, block_size=N)
WCS = [0x10, 0x28, 0x59, 0xFB, 0x3A, 0x6C, 0x8B, 0x10]
N_ITER = int(math.ceil(math.log2(P))) + 1


@pytest.fixture(scope="module")
def blocks():
    """Eight synthetic analyzed blocks, each alone and stacked."""
    rng = np.random.default_rng(41)
    blks = [synth_block(rng, wc, sparsity=float(rng.uniform(0.2, 0.8)))[0] for wc in WCS]
    return blks, jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *blks)


@pytest.mark.parametrize("kbps", [48.0, 128.0, 320.0])
def test_bisect_matches_cbr_search(blocks, kbps):
    """Counts and bytes of the port's bisection from ulcx's prepare_fast
    output == ulcx's _cbr_search and encode_pass_materialize from
    prepare_block, block by block."""
    blks, stacked = blocks
    cfg = CodecConfig(**KW, rate_search="bisect")
    tcfg = TCodecConfig(**KW, rate_search="bisect")
    budget = int(N * kbps * 1000.0 / 44100.0)
    fb = jfe.prepare_fast(stacked, cfg)
    fbt = tfe.FastBlockData(*(torch.from_numpy(np.array(x)) for x in fb))
    n_nz = torch.from_numpy(np.array(stacked.n_nz))
    n_out, size, data = tfe.search_materialize_scan(
        fbt, n_nz, torch.full((len(WCS),), budget, dtype=torch.int32), tcfg, MAX_BYTES)

    search = jax.jit(lambda bd, nz: _cbr_search(bd, nz, jnp.int32(budget), cfg))
    mat = jax.jit(lambda bd, k: jenc.encode_pass_materialize(bd, k, MAX_BYTES, "segment"))
    for i, blk in enumerate(blks):
        bd = jenc.prepare_block(blk, cfg)
        want_n = int(search(bd, blk.n_nz))
        assert int(n_out[i]) == want_n, (i, kbps)
        want_bits, want_by = mat(bd, jnp.int32(want_n))
        assert int(size[i]) == int(want_bits)
        nb = int(want_bits) // 8
        assert data[i, :nb].numpy().tobytes() == np.asarray(want_by)[:nb].tobytes()
    assert (size.numpy() <= budget + 7).all()


def _counting(monkeypatch):
    """Replace the kernel walks by counting passthroughs."""
    counts = dict.fromkeys(ek.Walks._fields, 0)

    def wrap(name, fn):
        def call(*a):
            counts[name] += 1
            return fn(*a)
        return call

    monkeypatch.setattr(ek, "KERNEL_WALKS", ek.Walks(
        *(wrap(n, f) for n, f in zip(ek.Walks._fields, ek.KERNEL_WALKS))))
    return counts


@pytest.mark.parametrize("search,b,want", [
    ("bisect", 3, (N_ITER + 1, N_ITER + 1, N_ITER, 1)),
    ("ladder", 3, (7, 7, 6, 1)),  # the scan path's exact ladder
    ("ladder", 8, (3, 3, 2, 1)),  # the kernel path's seeded ladder
])
def test_walks_per_block_step(monkeypatch, search, b, want):
    counts = _counting(monkeypatch)
    x = _signals(2)[:b]
    tcfg = TCodecConfig(**KW, rate_search=search)
    batch_encode(torch.from_numpy(x), tcfg, "cbr", device="cpu", rate_kbps=128.0)
    assert tuple(counts.values()) == tuple(2 * w for w in want)


@pytest.fixture(scope="module")
def x():
    return _signals(3)


@pytest.mark.parametrize("mode", ["cbr", "abr"])
def test_bisect_end_to_end_matches_ulcx(x, mode):
    """Against ulcx's scan path with rate_search="bisect", both packages
    configured alike (at eight streams "auto" would take the kernel
    path's plan, which ignores rate_search)."""
    kw = MODES[mode]
    cfg = CodecConfig(**KW, rate_search="bisect", use_pallas="off")
    tcfg = TCodecConfig(**KW, rate_search="bisect", use_pallas="off")
    want, _ = jax.jit(lambda b: j_batch_encode(b, cfg, mode, **kw))(jnp.asarray(x))
    got, _ = batch_encode(torch.from_numpy(x), tcfg, mode, device="cpu", **kw)
    w_sizes, w_data = np.asarray(want.size_bits), np.asarray(want.data)
    g_sizes, g_data = got.size_bits.numpy(), got.data.numpy()
    np.testing.assert_array_equal(got.window_ctrl.numpy(), np.asarray(want.window_ctrl))
    np.testing.assert_array_equal(_n_nz_port(x), _n_nz_ulcx(x))
    if mode == "cbr":
        assert (g_sizes <= int(N * 128.0 * 1000.0 / 44100.0)).all()
    assert abs(int(g_sizes.sum()) - int(w_sizes.sum())) <= 0.01 * int(w_sizes.sum())
    corrupt, snr = _decode_snr(x, g_sizes, g_data)
    assert not corrupt.any()
    _, snr_ulcx = _decode_snr(x, w_sizes, w_data)
    assert abs(snr - snr_ulcx) <= 0.3, (snr, snr_ulcx)


def _raising(*_):
    raise AssertionError("use_pallas='off' called a kernel wrapper")


@pytest.mark.parametrize("search", ["ladder", "bisect"])
def test_off_matches_default(monkeypatch, x, search):
    """Bytes and PCM of use_pallas="off" == the default's on the CPU at
    four streams, where both take the scan path's plan (the kernels'
    wrappers, the plain walks), and "off" reaches none of the kernels'
    wrappers."""
    kw = MODES["cbr"]
    xs = torch.from_numpy(x[:4, :2])
    base, _ = batch_encode(xs, TCodecConfig(**KW, rate_search=search), "cbr", device="cpu", **kw)
    win = 2 * MAX_BYTES
    streams = np.zeros((4, 3 * win), np.uint8)
    sizes, data = base.size_bits.numpy(), base.data.numpy()
    for i in range(4):
        off = 0
        for j in range(2):
            nb = int(sizes[i, j]) // 8
            streams[i, off: off + nb] = data[i, j, :nb]
            off += nb
    base_pcm = batch_decode(torch.from_numpy(streams), 2, win, TCodecConfig(**KW), device="cpu")

    from ulcx_torch import _build
    monkeypatch.setattr(_build, "on_cpu", _raising)  # every kernel wrapper's first step
    off_cfg = TCodecConfig(**KW, rate_search=search, use_pallas="off")
    got, _ = batch_encode(xs, off_cfg, "cbr", device="cpu", **kw)
    for name in ("size_bits", "data", "window_ctrl"):
        assert torch.equal(getattr(got, name), getattr(base, name)), name
    pcm = batch_decode(torch.from_numpy(streams), 2, win, off_cfg, device="cpu")
    for a, b in zip(pcm, base_pcm):
        assert torch.equal(a, b)
    with pytest.raises(AssertionError, match="kernel wrapper"):
        batch_encode(xs, TCodecConfig(**KW), "cbr", device="cpu", **kw)
