"""The port's folded encode forms against its own per-block loop, and
its whole-chunk analysis against ulcx's.

ulcx's contracts (tests/test_stream_flat.py, ulcx/codec/encoder.py):
``fold_bitstream`` changes no byte against the per-block loop;
``flat_stream`` gives identical sizes and window control and, on this
corpus, identical bytes up to each block's size. bs256, B=8 streams x
T=4 blocks, mono and stereo, CBR and VBR, all on the CPU (plain walks).
``analyze_stream_batched`` is held to ulcx's from the same mid-stream
carry: decisions exact, floats to the transform's summation order.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bench import make_corpus
from ulcx.analysis.batched import analyze_block_batched as j_analyze_block
from ulcx.analysis.batched import analyze_stream_batched as j_analyze_stream
from ulcx.codec.encoder import init_carry_batched as j_init
from ulcx.utils.config import CodecConfig
from ulcx_torch.analysis.batched import analyze_block_batched as t_analyze_block
from ulcx_torch.analysis.batched import analyze_stream_batched as t_analyze_stream
from ulcx_torch.analysis.block import carry_from_numpy, carry_to_numpy
from ulcx_torch.codec import encoder as tenc
from ulcx_torch.parallel.mesh import batch_encode
from ulcx_torch.utils.config import CodecConfig as TCodecConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, B, T = 256, 8, 4
MODES = {"cbr": {"rate_kbps": 128.0}, "vbr": {"quality": 50.0}}
KNOBS = {"fold2": {"fold_bitstream": 2}, "foldT": {"fold_bitstream": T},
         "flat": {"flat_stream": True}}


def _cfg(c, **kw):
    return TCodecConfig(rate_hz=44100, n_chan=c, block_size=N, **kw)


def _blocks(c):
    return torch.from_numpy(np.ascontiguousarray(make_corpus(B, T, N)[:, :, :c]))


@pytest.fixture(scope="module")
def per_block():
    """{(channels, mode): (EncodedBlock [B, T], final carry)} of the
    per-block loop, encoded once."""
    return {(c, mode): tenc.encode_stream_batched(_blocks(c), _cfg(c), mode, **kw)
            for c in (1, 2) for mode, kw in MODES.items()}


def _count_bitstream_calls(monkeypatch):
    """Record the batch size of every bitstream-stage call."""
    calls = []
    inner = tenc._encode_analyzed_fast

    def counted(blk, *a, **kw):
        calls.append(blk.n_nz.shape[0])
        return inner(blk, *a, **kw)

    monkeypatch.setattr(tenc, "_encode_analyzed_fast", counted)
    return calls


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("c", [1, 2])
def test_folded_equals_per_block(per_block, monkeypatch, c, mode, knob):
    want, want_carry = per_block[c, mode]
    calls = _count_bitstream_calls(monkeypatch)
    got, carry = tenc.encode_stream_batched(_blocks(c), _cfg(c, **KNOBS[knob]), mode, **MODES[mode])
    fold = KNOBS[knob].get("fold_bitstream", T)
    assert calls == [fold * B] * (T // fold)  # the stages really ran folded

    assert got.data.shape == want.data.shape == (B, T, 2 * c * N)
    assert torch.equal(got.size_bits, want.size_bits)
    assert torch.equal(got.window_ctrl, want.window_ctrl)
    if knob == "flat":
        # bytes up to each block's size; complexity and the carry's
        # filter state to the transform's summation order
        pos = torch.arange(got.data.shape[-1]) * 8
        inside = pos < want.size_bits[..., None]
        assert torch.equal(got.data[inside], want.data[inside])
        np.testing.assert_allclose(got.complexity.numpy(), want.complexity.numpy(), atol=1e-5)
        for g, w in zip(jax.tree_util.tree_leaves(carry_to_numpy(carry)),
                        jax.tree_util.tree_leaves(carry_to_numpy(want_carry))):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    else:
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        for g, w in zip(jax.tree_util.tree_leaves(carry_to_numpy(carry)),
                        jax.tree_util.tree_leaves(carry_to_numpy(want_carry))):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("knob", ["fold2", "flat"])
def test_folded_scan_major_layout(per_block, knob):
    want, _ = per_block[2, "vbr"]
    got, _ = batch_encode(_blocks(2), _cfg(2, **KNOBS[knob]), "vbr", scan_major=True, device="cpu",
                          **MODES["vbr"])
    assert got.data.shape == (T, B, 4 * N)
    for g, w in zip(got, want):
        assert torch.equal(g.transpose(0, 1), w)


def test_fold_not_dividing_t_takes_the_block_loop(per_block, monkeypatch):
    want, _ = per_block[1, "cbr"]
    calls = _count_bitstream_calls(monkeypatch)
    got, _ = tenc.encode_stream_batched(_blocks(1), _cfg(1, fold_bitstream=3), "cbr",
                                        **MODES["cbr"])
    assert calls == [B] * T
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_folded_continues_from_a_carry(per_block):
    """Two blocks per block, the carry passed on, two more folded."""
    want, _ = per_block[2, "cbr"]
    x = _blocks(2)
    _, carry = tenc.encode_stream_batched(x[:, :2], _cfg(2), "cbr", **MODES["cbr"])
    for knob in ("foldT", "flat"):
        cfg = _cfg(2, **{k: (2 if k == "fold_bitstream" else v) for k, v in KNOBS[knob].items()})
        tail, _ = tenc.encode_stream_batched(x[:, 2:], cfg, "cbr", carry=carry, **MODES["cbr"])
        assert torch.equal(tail.size_bits, want.size_bits[:, 2:])
        assert torch.equal(tail.window_ctrl, want.window_ctrl[:, 2:])


def test_analyze_stream_batched_matches_ulcx():
    """Both whole-chunk analyses from ulcx's carry after one block."""
    c = 2
    kw = dict(rate_hz=44100, n_chan=c, block_size=N)
    cfg, tcfg = CodecConfig(**kw), TCodecConfig(**kw)
    x = make_corpus(B, T + 1, N)
    jc, _ = jax.jit(lambda ca, blk: j_analyze_block(ca, blk, cfg))(j_init(cfg, B), jnp.asarray(x[:, 0]))
    carry_np = jax.tree_util.tree_map(np.asarray, jc)
    want_carry, want = jax.jit(lambda ca, b: j_analyze_stream(ca, b, cfg))(jc, jnp.asarray(x[:, 1:]))
    carry, got = t_analyze_stream(carry_from_numpy(carry_np, "cpu"), torch.from_numpy(x[:, 1:]), tcfg)

    np.testing.assert_array_equal(got.window_ctrl.numpy(), np.asarray(want.window_ctrl))
    np.testing.assert_array_equal(got.n_nz.numpy(), np.asarray(want.n_nz))
    assert len(set((np.asarray(want.window_ctrl) >> 4).tolist())) >= 2  # windows switch
    assert got.mdct.shape == (B * T, c, N)
    ref = np.asarray(want.mdct, np.float64)
    assert np.abs(got.mdct.numpy() - ref).max() / np.abs(ref).max() < 1e-5
    np.testing.assert_allclose(got.complexity.numpy(), np.asarray(want.complexity), atol=1e-5)
    for g, w in zip(jax.tree_util.tree_leaves(carry_to_numpy(carry)),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, want_carry))):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)

    # and block for block what the port's own per-block chain gives
    tc = carry_from_numpy(carry_np, "cpu")
    for j in range(T):
        tc, blk = t_analyze_block(tc, torch.from_numpy(x[:, 1 + j]), tcfg)
        rows = slice(j, None, T)  # b-major flat batch: block j of every stream
        assert torch.equal(got.window_ctrl[rows], blk.window_ctrl)
        assert torch.equal(got.n_nz[rows], blk.n_nz)


def test_flat_and_fold_are_served_settings():
    """Neither knob is refused any more, alone or together (flat wins,
    as in ulcx)."""
    x = torch.zeros(2, 2, 1, N)
    for change in ({"flat_stream": True}, {"fold_bitstream": 2},
                   {"flat_stream": True, "fold_bitstream": 2}):
        out, _ = batch_encode(x, _cfg(1, **change), "cbr", rate_kbps=128.0, device="cpu")
        assert out.size_bits.shape == (2, 2)
    with pytest.raises(ValueError, match="fold_bitstream"):
        dataclasses.replace(_cfg(1), fold_bitstream=0)
