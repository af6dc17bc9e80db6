"""The plain reference against the definitions it implements and against
the port on the CPU, and the work counts of the roofline metrics."""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest
import torch
from bench_helpers import REPO

from benchmarks import spec
from benchmarks.corpus import make_corpus
from benchmarks.reference import checks, transform, window


@pytest.mark.parametrize("s", [16, 64, 256])
def test_fft_transforms_equal_the_direct_sums(s):
    rng = np.random.default_rng(s)
    n = np.arange(2 * s)[:, None]
    k = np.arange(s)[None, :]
    basis = np.cos(np.pi / s * (n + 0.5 + s / 2) * (k + 0.5))
    z, x = rng.standard_normal(2 * s), rng.standard_normal(s)
    np.testing.assert_allclose(transform.mdct(z), -(2.0 / s) * (z @ basis), atol=1e-12)
    np.testing.assert_allclose(transform.imdct(x), -(basis @ x), atol=1e-11)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, benchmarks.reference.checks, benchmarks.bitgen, benchmarks.corpus; "
            "bad = {m.split('.')[0] for m in sys.modules} & {'ulcx_torch', 'ulcx', 'jax', 'jaxlib'}; "
            "sys.exit(len(bad))")
    assert subprocess.run([sys.executable, "-c", code], cwd=REPO).returncode == 0


@pytest.mark.parametrize("reverse", [False, True])
def test_ema_equals_its_recurrence(reverse):
    rng = np.random.default_rng(3)
    v, init, r = rng.random((3, 2048)), rng.random(3), 0.995
    want = np.empty_like(v)
    x = init.copy()
    for i in range(v.shape[1])[::-1] if reverse else range(v.shape[1]):
        x = r * x + (1 - r) * v[:, i]
        want[:, i] = x
    np.testing.assert_allclose(window.ema(v, r, init, reverse=reverse), want, rtol=1e-12)


@pytest.mark.parametrize("n,streams,blocks", [(2048, 8, 24), (512, 8, 16)])
def test_window_controls_agree_with_the_port(n, streams, blocks):
    """The float64 detector against the port's float32 one on the CPU,
    corpus streams from their start, the pool cycled as the cells cycle
    it."""
    from ulcx_torch.analysis.batched import analyze_block_batched
    from ulcx_torch.codec.encoder import init_carry_batched
    from ulcx_torch.utils.config import CodecConfig

    cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=n)
    x = make_corpus(torch.Generator().manual_seed(n), streams, 8, 2, n, 44100, "cpu")
    carry, got = init_carry_batched(cfg, streams, "cpu"), []
    for t in range(blocks):
        carry, blk = analyze_block_batched(carry, x[:, t % 8], cfg)
        got.append(blk.window_ctrl.numpy())
    want = window.window_controls(x.numpy(), blocks, 44100)
    assert (np.stack(got, 1) != 0x10).any()  # the corpus's bursts switch windows
    np.testing.assert_array_equal(np.stack(got, 1), want)


def test_companded_quantization():
    x = np.array([0.0, 0.49, 0.5, 2.49, 2.5, -6.5, 100.0, -100.0])
    assert checks.companded(x).tolist() == [0, 0, 1, 1, 2, -3, 7, -7]


@pytest.fixture(scope="module")
def port_cpu():
    """The port's CBR-128 encode of 6 corpus streams x 4 bs2048 blocks on
    the CPU, and its decode of those bytes."""
    from ulcx_torch.codec.encoder import encode_stream_batched
    from ulcx_torch.parallel.mesh import batch_decode
    from ulcx_torch.utils.config import CodecConfig

    cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=2048)
    x = make_corpus(torch.Generator().manual_seed(5), 6, 4, 2, 2048, 44100, "cpu")
    enc, _ = encode_stream_batched(x, cfg, "cbr", rate_kbps=128)
    data, size = enc.data.numpy(), enc.size_bits.numpy()
    win = -(-int(size.max() // 8) // 64) * 64 + 64
    streams = np.zeros((6, 5 * win + 64), np.uint8)
    for b in range(6):
        off = 0
        for t in range(4):
            nb = size[b, t] // 8
            streams[b, off:off + nb] = data[b, t, :nb]
            off += nb
    pcm, bits, corrupt = batch_decode(torch.from_numpy(streams), 4, win, cfg, device="cpu")
    return x.numpy(), data, size, enc.window_ctrl.numpy(), streams, pcm.numpy(), bits.numpy(), corrupt.numpy()


def test_port_encode_agrees_with_the_reference(port_cpu):
    x, data, size, wc, *_ = port_cpu
    blocks = {b: [(data[b, t], int(size[b, t])) for t in range(4)] for b in range(6)}
    got = checks.encode_numbers(blocks, {b: x[b] for b in range(6)}, [(b, t) for b in range(6) for t in range(3)],
                                2048, 2)
    assert got["bad_blocks"] == 0 and got["coded"] > 10000 and got["requant_mismatch"] == 0.0
    assert all(checks.header_wc(data[b, t]) == wc[b, t] for b in range(6) for t in range(4))


def test_port_decode_agrees_with_the_reference(port_cpu):
    *_, streams, pcm, bits, corrupt = port_cpu
    for b in range(6):
        rbits, rcorrupt, rpcm = checks.decode_stream(streams[b], 4, 2048, 2, True)
        assert np.array_equal(rbits, bits[b]) and np.array_equal(rcorrupt, corrupt[b])
        assert checks.pcm_gap(pcm[b], rpcm) < 1e-5  # float32 GEMMs; TF32 reads ~1e-4


@pytest.mark.parametrize("name", ["stereo44k_cbr128_bs2048", "stereo44k_cbr128_bs32768"])
def test_budgets_are_the_ports(name):
    from ulcx_torch.codec.encoder import cbr_bit_budget
    from ulcx_torch.utils.config import CodecConfig

    conf = spec.config(name)
    assert int(cbr_bit_budget(CodecConfig(**conf["codec"]), conf["rate_kbps"])) == conf["budget_bits"]


def test_walk_work_counts():
    """Per launch at B = 512, P = 4096 (PERF.md's kernel table: p1 92.3 MB,
    p2 159.4, p3 size 83.9, p3 materialize 130.0 (its bound 38.8 us),
    FSM + placement 11.8, RNG-expand 16.8 at an 832-byte window), and the
    plans' size rounds."""
    walks = spec.metric_module("walks_roofline_pct")
    dec = spec.metric_module("decode_walks_roofline_pct")
    got = {k: round(v / 1e6, 1) for k, v in walks.round_bytes(512, 4096).items()}
    assert got == {"p1": 92.3, "p2": 159.4, "p3_size": 83.9, "p3_materialize": 130.1}
    assert round(walks.round_bytes(512, 4096)["p3_materialize"] / 3.35e12 * 1e6, 1) == 38.8
    assert {k: round(v / 1e6, 1) for k, v in dec.block_bytes(512, 4096, 832).items()} == {
        "fsm_place": 11.8, "rng_expand": 16.8}
    # the seeded ladder (3, 3, 2, 1); the exact ladder (7, 7, 6, 1) and (9, 9, 8, 1)
    assert walks.size_rounds(512, 4096) == 2 and walks.size_rounds(8192, 4096) == 2
    assert walks.size_rounds(13, 4096) == 6 and walks.size_rounds(256, 65536) == 8
    assert walks.size_rounds(64, 4096) == 2
    assert round(walks.pass_bytes(256, 65536) / 3.35e12 * 1e3, 2) == 7.32
