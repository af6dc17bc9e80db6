"""The port's single-stream entry points against ulcx's.

``encode_stream`` / ``encode_block`` and ``decode_stream`` /
``decode_block`` code one stream as a batch of one. One bs256 stereo
stream of T=16 blocks (ulcx's kernels need the folded batch, here the
blocks of a call, to be a multiple of 8, and the stream is also coded
in two halves), everything on the CPU.

Encode: against ulcx's ``encode_stream`` (kernels in interpret mode)
window control exact and total size within 1 %; against itself, bytes
that depend neither on how the stream is chunked nor on a caller-set
fold. Decode, on ulcx-encoded bytes: bits, corrupt flags and the carry's
``rng`` and ``prev_last_ss`` exact against ulcx's ``decode_stream`` (its
scan decoder, whose PCM differs from the kernel path's by up to 2e-5),
PCM within 1e-5 RMS of ulcx's kernel path
(``decode_stream_batched`` of the stream as a batch of one, interpret
mode); a call chained through ``(offset, carry)`` equals one call. Both
packages' carries convert into each other, an ``rng`` above 2^31 among
the cases.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bench import make_corpus
from ulcx.analysis.block import EncoderCarry as JEncoderCarry
from ulcx.codec import decoder as jdec
from ulcx.codec.encoder import encode_stream as j_encode_stream
from ulcx.utils.config import CodecConfig
from ulcx_torch.analysis.block import carry_from_numpy, carry_to_numpy
from ulcx_torch.codec import decoder as tdec
from ulcx_torch.codec import encoder as tenc
from ulcx_torch.utils.config import CodecConfig as TCodecConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, C, T = 256, 2, 16
KW = dict(rate_hz=44100, n_chan=C, block_size=N, use_pallas="on")
CFG, TCFG = CodecConfig(**KW), TCodecConfig(**KW)  # ulcx's, the port's
RATE = {"rate_kbps": 128.0}
WIN = 2 * C * N  # a window as large as the largest possible block
PCM_RMS = 1e-5


@pytest.fixture(scope="module")
def x():
    return make_corpus(4, T, N)[3]  # [T, C, N]; stream 3 has transients


@pytest.fixture(scope="module")
def ulcx_enc(x):
    """ulcx's encode_stream of the whole stream and of its first half
    (outputs and carries as numpy)."""
    enc = jax.jit(lambda b: j_encode_stream(b, CFG, "cbr", **RATE))
    full = jax.tree_util.tree_map(np.asarray, enc(jnp.asarray(x)))
    half = jax.tree_util.tree_map(np.asarray, enc(jnp.asarray(x[: T // 2])))
    return full, half


@pytest.fixture(scope="module")
def port_enc(x):
    return tenc.encode_stream(x, TCFG, "cbr", device="cpu", **RATE)


def _pack(sizes, data):
    """One stream's blocks -> (padded byte stream [S], its length)."""
    stream = np.zeros(T * WIN + WIN + 64, np.uint8)
    off = 0
    for j in range(len(sizes)):
        nb = int(sizes[j]) // 8
        stream[off : off + nb] = data[j, :nb]
        off += nb
    return stream, off


@pytest.fixture(scope="module")
def ulcx_stream(ulcx_enc):
    (out, _), _ = ulcx_enc
    return _pack(out.size_bits, out.data)


def _count_bitstream_calls(monkeypatch):
    calls = []
    inner = tenc._encode_analyzed_fast

    def counted(blk, *a, **kw):
        calls.append(blk.n_nz.shape[0])
        return inner(blk, *a, **kw)

    monkeypatch.setattr(tenc, "_encode_analyzed_fast", counted)
    return calls


# ---------------------------------------------------------------------------
# encode


def test_encode_stream_matches_ulcx(ulcx_enc, port_enc):
    (want, _), _ = ulcx_enc
    got, carry = port_enc
    assert got.data.shape == (T, 2 * C * N) and got.size_bits.shape == (T,)
    np.testing.assert_array_equal(got.window_ctrl.numpy(), want.window_ctrl)
    g, w = int(got.size_bits.sum()), int(want.size_bits.sum())
    assert abs(g - w) <= 0.01 * w
    assert int(got.size_bits.max()) <= int(N * 128.0 * 1000.0 / 44100.0)


def test_encode_stream_carry_has_ulcx_leaves(ulcx_enc, port_enc):
    """The single-stream carry converts to ulcx's unbatched leaves, shape
    and dtype, and holds its state to float rounding."""
    (_, want), _ = ulcx_enc
    got = carry_to_numpy(port_enc[1])
    init = jax.tree_util.tree_map(np.asarray, JEncoderCarry.init(CFG))
    for g, w, i in zip(*(jax.tree_util.tree_leaves(t) for t in (got, want, init))):
        assert g.dtype == w.dtype == i.dtype and g.shape == w.shape == i.shape
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
    back = carry_from_numpy(got, "cpu")
    for g, w in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(port_enc[1])):
        assert torch.equal(g, w)


def test_encode_stream_folds_the_whole_chunk(x, monkeypatch):
    calls = _count_bitstream_calls(monkeypatch)
    tenc.encode_stream(x[:4], TCFG, "vbr", device="cpu", quality=50.0)
    assert calls == [4]  # one stream, the bitstream stages once over its 4 blocks


def test_encode_stream_bytes_do_not_depend_on_chunking(x, port_enc):
    want, want_carry = port_enc
    head, carry = tenc.encode_stream(x[: T // 2], TCFG, "cbr", device="cpu", **RATE)
    tail, carry = tenc.encode_stream(x[T // 2 :], TCFG, "cbr", carry=carry, device="cpu", **RATE)
    for h, t, w in zip(head, tail, want):
        assert torch.equal(torch.cat([h, t]), w)
    for g, w in zip(jax.tree_util.tree_leaves(carry), jax.tree_util.tree_leaves(want_carry)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("t,fold,calls_want", [(T, 4, [4] * (T // 4)), (4, 3, [1] * 4)])
def test_encode_stream_honours_a_caller_set_fold(x, port_enc, monkeypatch, t, fold, calls_want):
    """Only the default fold of 1 is replaced by T; a fold that does not
    divide T takes the per-block loop. Bytes are the same either way."""
    calls = _count_bitstream_calls(monkeypatch)
    got, _ = tenc.encode_stream(x[:t], dataclasses.replace(TCFG, fold_bitstream=fold), "cbr",
                                device="cpu", **RATE)
    assert calls == calls_want
    for g, w in zip(got, port_enc[0]):
        assert torch.equal(g, w[:t])


def test_encode_stream_flat(x, port_enc, monkeypatch):
    calls = _count_bitstream_calls(monkeypatch)
    got, _ = tenc.encode_stream(x, dataclasses.replace(TCFG, flat_stream=True), "cbr",
                                device="cpu", **RATE)
    assert calls == [T]
    assert torch.equal(got.size_bits, port_enc[0].size_bits)
    assert torch.equal(got.window_ctrl, port_enc[0].window_ctrl)


def test_encode_stream_continues_from_ulcx_carry(x, ulcx_enc):
    """ulcx's unbatched carry after the first half, converted, continues
    in the port with ulcx's window decisions."""
    (want, _), (_, carry_np) = ulcx_enc
    tail, _ = tenc.encode_stream(x[T // 2 :], TCFG, "cbr", carry=carry_from_numpy(carry_np, "cpu"),
                                 device="cpu", **RATE)
    np.testing.assert_array_equal(tail.window_ctrl.numpy(), want.window_ctrl[T // 2 :])
    g, w = int(tail.size_bits.sum()), int(want.size_bits[T // 2 :].sum())
    assert abs(g - w) <= 0.01 * w


def test_encode_block_steps_equal_encode_stream(x, port_enc):
    """encode_block is ulcx's single-block form, on the scan path's plan
    whatever use_pallas says: its steps give the bytes of encode_stream
    of three blocks, which takes that plan too (3 is no multiple of 8)."""
    scan = dataclasses.replace(TCFG, use_pallas="auto")
    want, _ = tenc.encode_stream(x[:3], scan, "cbr", device="cpu", **RATE)
    carry = jax.tree_util.tree_map(lambda v: v[0], tenc.init_carry_batched(TCFG, 1, "cpu"))
    for j in range(3):
        carry, enc = tenc.encode_block(carry, torch.from_numpy(x[j]), TCFG, "cbr", **RATE)
        assert enc.size_bits.shape == () and carry.sample_prev.shape == (C, N)
        for g, w in zip(enc, want):
            assert torch.equal(g, w[j])


def test_single_stream_entry_points_default_to_the_card(x):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tenc.encode_stream(x, TCFG, "cbr", **RATE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdec.decode_stream(np.zeros(4096, np.uint8), 1, 64, TCFG)


# ---------------------------------------------------------------------------
# decode


@pytest.fixture(scope="module")
def ulcx_dec(ulcx_stream):
    """ulcx's decode_stream (scan decoder) of its own bytes."""
    stream, _ = ulcx_stream
    out = jax.jit(lambda s: jdec.decode_stream(s, T, WIN, CFG))(jnp.asarray(stream))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def port_dec(ulcx_stream):
    return tdec.decode_stream(ulcx_stream[0], T, WIN, TCFG, device="cpu")


def test_decode_stream_matches_ulcx(ulcx_enc, ulcx_stream, ulcx_dec, port_dec):
    stream, length = ulcx_stream
    w_pcm, w_bits, w_corrupt, (w_off, w_carry) = ulcx_dec
    pcm, bits, corrupt, (off, carry) = port_dec
    assert pcm.shape == (T, C, N) and bits.shape == corrupt.shape == (T,)
    np.testing.assert_array_equal(bits.numpy(), w_bits)
    np.testing.assert_array_equal(corrupt.numpy(), w_corrupt)
    assert not corrupt.any()
    assert ((bits.numpy() + 7) // 8 * 8 == ulcx_enc[0][0].size_bits).all()
    assert off.shape == () and int(off) == int(w_off) == length
    got = tdec.decoder_carry_to_numpy(carry)
    assert got.rng.dtype == np.uint32 and got.rng == w_carry.rng
    assert got.prev_last_ss.dtype == np.int32 and got.prev_last_ss == w_carry.prev_last_ss
    assert got.lap.shape == w_carry.lap.shape == (C, N // 2)
    np.testing.assert_allclose(got.lap, w_carry.lap, atol=1e-4)
    # ulcx's kernel path on the same stream, a batch of one
    k_pcm, k_bits, _ = jax.jit(lambda s: jdec.decode_stream_batched(
        s, T, WIN, CFG, interpret=True))(jnp.asarray(stream)[None])
    np.testing.assert_array_equal(bits.numpy(), np.asarray(k_bits)[0])
    rms = np.sqrt(np.mean((pcm.numpy() - np.asarray(k_pcm)[0]) ** 2))
    assert rms <= PCM_RMS, rms


def test_decode_stream_chained_equals_one_call(ulcx_stream, port_dec):
    stream, _ = ulcx_stream
    h = tdec.decode_stream(stream, 3, WIN, TCFG, device="cpu")
    t = tdec.decode_stream(stream, T - 3, WIN, TCFG, offset=h[3][0], carry=h[3][1], device="cpu")
    for a, b, w in zip(h[:3], t[:3], port_dec[:3]):
        assert torch.equal(torch.cat([a, b]), w)
    assert torch.equal(t[3][0], port_dec[3][0])
    for g, w in zip(t[3][1], port_dec[3][1]):
        assert torch.equal(g, w)


def test_decode_stream_is_row_of_batched(ulcx_stream, port_dec):
    stream = torch.from_numpy(ulcx_stream[0])
    pcm, bits, corrupt = tdec.decode_stream_batched(stream[None], T, WIN, TCFG)
    for g, w in zip((pcm, bits, corrupt), port_dec[:3]):
        assert torch.equal(g[0], w)


def test_decode_block_steps_equal_decode_stream(ulcx_stream, ulcx_dec, port_dec):
    stream = torch.from_numpy(ulcx_stream[0])
    carry = tdec.DecoderCarry(*(v[0] for v in tdec.DecoderCarry.init(TCFG, 1, "cpu")))
    off = 0
    for j in range(T):
        pcm, carry, bits, corrupt = tdec.decode_block(stream[off : off + WIN], carry, TCFG)
        assert pcm.shape == (C, N) and bits.shape == corrupt.shape == ()
        assert torch.equal(pcm, port_dec[0][j])
        assert int(bits) == int(ulcx_dec[1][j]) and not bool(corrupt)
        off += (int(bits) + 7) // 8
    for g, w in zip(carry, port_dec[3][1]):
        assert torch.equal(g, w)


def test_decode_stream_continues_from_ulcx_carry(ulcx_stream, ulcx_dec, port_dec):
    """ulcx decodes three blocks; its (offset, carry), converted,
    continue in the port."""
    stream, _ = ulcx_stream
    _, _, _, (off, carry) = jax.jit(lambda s: jdec.decode_stream(s, 3, WIN, CFG))(jnp.asarray(stream))
    carry = tdec.decoder_carry_from_numpy(jax.tree_util.tree_map(np.asarray, carry), "cpu")
    pcm, bits, corrupt, (off2, carry2) = tdec.decode_stream(
        stream, T - 3, WIN, TCFG, offset=int(off), carry=carry, device="cpu")
    np.testing.assert_array_equal(bits.numpy(), ulcx_dec[1][3:])
    assert not corrupt.any() and int(off2) == int(ulcx_dec[3][0])
    assert torch.equal(carry2.rng, port_dec[3][1].rng)
    assert float(torch.sqrt(torch.mean((pcm - port_dec[0][3:]) ** 2))) <= 2e-5  # scan decoder's lap


@pytest.mark.parametrize("rng", [1234567, 0x80000000, 0xFFFFFFFF])
@pytest.mark.parametrize("batch", [None, 3])
def test_decoder_carry_converters_round_trip(rng, batch):
    lead = () if batch is None else (batch,)
    r = np.random.default_rng(rng % 1000)
    want = jdec.DecoderCarry(
        lap=r.standard_normal(lead + (C, N // 2)).astype(np.float32),
        prev_last_ss=np.full(lead, N // 4, np.int32),
        rng=np.full(lead, rng, np.uint32),
    )
    port = tdec.decoder_carry_from_numpy(want, "cpu")
    assert port.rng.dtype == torch.int32 and port.prev_last_ss.dtype == torch.int32
    assert (port.rng.numpy().view(np.uint32) == rng).all()  # the bits, not a saturated value
    back = tdec.decoder_carry_to_numpy(port)
    for g, w in zip(back, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
