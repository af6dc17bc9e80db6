"""The slice end to end: the port's batch_encode against ulcx's.

Eight bs256 stereo streams (five bench.make_corpus streams, then
tests/material.py speech, percussion and polyphonic) are encoded by
ulcx (kernels in interpret mode) and by the port on the CPU, in CBR-128,
ABR and VBR. Decisions must agree exactly (window control, coded
counts); bytes may differ where the two packages' float rounding flips
a near-tie, so sizes are held to 1 % in total and quality to 0.3 dB of
round-trip SNR, both decoded by the port's decoder (itself held to
ulcx's decoder by tests/test_torch_decode.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import material
from bench import make_corpus
from ulcx.analysis.batched import analyze_block_batched as j_analyze
from ulcx.codec.encoder import encode_stream_batched as j_encode_stream
from ulcx.codec.encoder import init_carry_batched as j_init
from ulcx.parallel.mesh import batch_encode as j_batch_encode
from ulcx.utils.config import CodecConfig
from ulcx_torch.analysis.batched import analyze_block_batched as t_analyze
from ulcx_torch.analysis.block import carry_from_numpy
from ulcx_torch.codec.encoder import encode_stream_batched as t_encode_stream
from ulcx_torch.codec.encoder import init_carry_batched as t_init
from ulcx_torch.codec.encoder import max_block_bytes
from ulcx_torch.parallel.mesh import batch_decode
from ulcx_torch.parallel.mesh import batch_encode as t_batch_encode
from ulcx_torch.utils.config import CodecConfig as TCodecConfig

N, C, T = 256, 2, 3
KW = dict(rate_hz=44100, n_chan=C, block_size=N, use_pallas="on")
CFG, TCFG = CodecConfig(**KW), TCodecConfig(**KW)  # ulcx's, the port's
BUDGET = int(N * 128.0 * 1000.0 / 44100.0)
MODES = {
    "cbr": {"rate_kbps": 128.0},
    "abr": {"rate_kbps": 128.0, "avg_complexity": 0.5},
    "vbr": {"quality": 50.0},
}


def _signals(t):
    real = [material.blocks_of(k, N, t, C) for k in ("speech", "percussion", "poly")]
    return np.concatenate([make_corpus(5, t, N), np.stack(real)]).astype(np.float32)


def _n_nz_ulcx(x, carry=None):
    """[B, T] coded-coefficient counts from ulcx's analysis chain."""
    step = jax.jit(lambda c, blk: j_analyze(c, blk, CFG))
    carry = j_init(CFG, x.shape[0]) if carry is None else carry
    out = []
    for j in range(x.shape[1]):
        carry, blk = step(carry, jnp.asarray(x[:, j]))
        out.append(np.asarray(blk.n_nz))
    return np.stack(out, 1)


def _n_nz_port(x, carry=None):
    carry = t_init(TCFG, x.shape[0], "cpu") if carry is None else carry
    out = []
    for j in range(x.shape[1]):
        carry, blk = t_analyze(carry, torch.from_numpy(x[:, j]), TCFG)
        out.append(blk.n_nz.numpy())
    return np.stack(out, 1)


def _decode_snr(x, sizes, data):
    """The port's batch_decode of [B, T] blocks; returns (corrupt flags,
    SNR in dB of decoded block t against input block t-1)."""
    b, t = sizes.shape
    win = max_block_bytes(CFG)
    streams = np.zeros((b, t * win + win + 64), np.uint8)
    for i in range(b):
        off = 0
        for j in range(t):
            nb = int(sizes[i, j]) // 8
            streams[i, off: off + nb] = data[i, j, :nb]
            off += nb
    pcm, _, corrupt = batch_decode(torch.from_numpy(streams), t, win, TCFG, device="cpu")
    want = x[:, : t - 1]
    err = pcm.numpy()[:, 1:] - want
    return corrupt.numpy(), 10 * np.log10((want ** 2).sum() / (err ** 2).sum())


@pytest.fixture(scope="module")
def x():
    return _signals(T)


@pytest.fixture(scope="module")
def n_nz_ulcx(x):
    return _n_nz_ulcx(x)


@pytest.mark.parametrize("mode", list(MODES))
def test_batch_encode_matches_ulcx(x, n_nz_ulcx, mode):
    kw = MODES[mode]
    want, _ = jax.jit(lambda b: j_batch_encode(b, CFG, mode, **kw))(jnp.asarray(x))
    got, stats = t_batch_encode(torch.from_numpy(x), TCFG, mode, device="cpu", **kw)
    w_sizes, w_data = np.asarray(want.size_bits), np.asarray(want.data)
    g_sizes, g_data = got.size_bits.numpy(), got.data.numpy()

    np.testing.assert_array_equal(got.window_ctrl.numpy(), np.asarray(want.window_ctrl))
    np.testing.assert_array_equal(_n_nz_port(x), n_nz_ulcx)
    if mode == "cbr":
        assert (g_sizes <= BUDGET).all()
    assert abs(int(g_sizes.sum()) - int(w_sizes.sum())) <= 0.01 * int(w_sizes.sum())
    assert int(stats["total_bits"]) == int(g_sizes.sum())

    corrupt, snr = _decode_snr(x, g_sizes, g_data)
    assert not corrupt.any()
    _, snr_ulcx = _decode_snr(x, w_sizes, w_data)
    assert abs(snr - snr_ulcx) <= 0.3, (snr, snr_ulcx)


def test_stream_continues_from_ulcx_carry():
    """Two blocks in ulcx, its carry converted, two more in the port:
    the second half meets the slice's bounds against ulcx's 4-block run,
    and the spliced stream decodes as well as ulcx's own."""
    x4 = _signals(4)
    kw = MODES["cbr"]
    enc = jax.jit(lambda b: j_encode_stream(b, CFG, "cbr", **kw))
    full, _ = enc(jnp.asarray(x4))
    head, carry = enc(jnp.asarray(x4[:, :2]))
    carry_np = jax.tree_util.tree_map(np.asarray, carry)
    tail, _ = t_encode_stream(torch.from_numpy(x4[:, 2:]), TCFG, "cbr",
                              carry=carry_from_numpy(carry_np, "cpu"), **kw)

    w_sizes, w_data = np.asarray(full.size_bits), np.asarray(full.data)
    np.testing.assert_array_equal(tail.window_ctrl.numpy(), np.asarray(full.window_ctrl)[:, 2:])
    np.testing.assert_array_equal(
        _n_nz_port(x4[:, 2:], carry_from_numpy(carry_np, "cpu")), _n_nz_ulcx(x4)[:, 2:])
    g_tail = tail.size_bits.numpy()
    assert (g_tail <= BUDGET).all()
    assert abs(int(g_tail.sum()) - int(w_sizes[:, 2:].sum())) <= 0.01 * int(w_sizes[:, 2:].sum())

    sizes = np.concatenate([np.asarray(head.size_bits), g_tail], axis=1)
    data = np.concatenate([np.asarray(head.data), tail.data.numpy()], axis=1)
    corrupt, snr = _decode_snr(x4, sizes, data)
    assert not corrupt.any()
    _, snr_ulcx = _decode_snr(x4, w_sizes, w_data)
    assert abs(snr - snr_ulcx) <= 0.3, (snr, snr_ulcx)


def test_scan_major_layout(x):
    """scan_major=True gives the same blocks, [T, B] first."""
    a, _ = t_batch_encode(torch.from_numpy(x[:, :2]), TCFG, "vbr", device="cpu", **MODES["vbr"])
    b, _ = t_batch_encode(torch.from_numpy(x[:, :2]), TCFG, "vbr", scan_major=True,
                          device="cpu", **MODES["vbr"])
    for u, v in zip(a, b):
        assert torch.equal(u, v.transpose(0, 1))


def test_gap_refuses_pallas_on():
    """As in ulcx: the gap noise window has no kernel, and "on" asks for
    one."""
    kw = dict(rate_hz=44100, n_chan=C, block_size=N, noise_run_window="gap", use_pallas="on")
    for cls in (CodecConfig, TCodecConfig):
        with pytest.raises(ValueError, match="scan-only"):
            cls(**kw)
