"""The pipelined single-stream decoder, the RNG jump-ahead and the draw
counts, against ulcx and against the port's ``decode_stream``.

``ops.rngjump.jump`` against stepping the xorshift32 one by one and
against ulcx's ``jump`` (random seeds, counts up to 2^30);
``fast_decode.draw_counts`` against ulcx's on real and synthetic flags;
``decoder.decode_stream_pipelined`` on a bs256 stereo stream of 10
blocks encoded by ulcx at 48 kbps (noise-fill and HF-extension records,
so the RNG draws; window switching): bits, corrupt flags, the offset,
the carry's ``rng`` and ``prev_last_ss`` exact against the port's
``decode_stream`` and ulcx's ``decode_stream_pipelined`` (kernels in
interpret mode); PCM within 1e-5 relative error and the lap within
1e-5, the bounds of tests/test_decode_pipelined.py (the transforms sum
over a batch of T blocks instead of one).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_decode_pipelined import T, _stream
from test_torch_decode_kernels import synthetic_flags
from ulcx.bitstream import fast_decode as jfd
from ulcx.codec import decoder as jdec
from ulcx.codec.encoder import max_block_bytes
from ulcx.ops import rngjump as jrj
from ulcx.utils.config import CodecConfig
from ulcx_torch.bitstream import decode_kernels as dk
from ulcx_torch.bitstream import fast_decode as tfd
from ulcx_torch.codec import decoder as tdec
from ulcx_torch.ops import rngjump as trj
from ulcx_torch.utils.config import CodecConfig as TCodecConfig

N, C = 256, 2
KW = dict(rate_hz=44100, n_chan=C, block_size=N, use_pallas="on")
CFG, TCFG = CodecConfig(**KW), TCodecConfig(**KW)  # ulcx's, the port's
WIN = max_block_bytes(CFG)
REL, LAP = 1e-5, 1e-5


def _u32(x):
    return np.asarray(x).astype(np.uint32)


def _seeds(rng, n):
    s = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    s[0], s[1], s[2] = 0, dk.SEED, 0xFFFFFFFF
    return s


@pytest.fixture(scope="module")
def stream():
    return np.array(_stream(np.random.default_rng(0xC0DEC)))


def _rel(got, want):
    err = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    return np.sqrt(err.var() / max(np.asarray(want, np.float64).var(), 1e-30))


def _port(stream, n_blocks=T, win=WIN, **kw):
    out = tdec.decode_stream_pipelined(torch.from_numpy(stream), n_blocks, win, TCFG,
                                       device="cpu", **kw)
    pcm, bits, corrupt, (off, carry) = out
    return pcm.numpy(), bits.numpy(), corrupt.numpy(), int(off), tdec.decoder_carry_to_numpy(carry)


@pytest.fixture(scope="module")
def pipelined(stream):
    return _port(stream)


@pytest.fixture(scope="module")
def sequential(stream):
    pcm, bits, corrupt, (off, carry) = tdec.decode_stream(torch.from_numpy(stream), T, WIN, TCFG,
                                                          device="cpu")
    return pcm.numpy(), bits.numpy(), corrupt.numpy(), int(off), tdec.decoder_carry_to_numpy(carry)


def test_jump_matches_stepping():
    """Counts 0-300 against the xorshift32 stepped one by one, in the
    int64 form the plain RNG walks use."""
    rng = np.random.default_rng(21)
    seeds = _seeds(rng, 64)
    counts = rng.integers(0, 301, 64)
    counts[:4] = (0, 1, 16, 300)
    got = trj.jump(torch.from_numpy(seeds.view(np.int32)), torch.from_numpy(counts))
    assert got.dtype == torch.int32
    want = torch.from_numpy(seeds.astype(np.int64))
    c = torch.from_numpy(counts)
    for k in range(300):
        want = torch.where(c > k, dk._xorshift(want), want)
    np.testing.assert_array_equal(_u32(got.numpy().view(np.uint32)), want.numpy().astype(np.uint32))
    assert got[0] == 0  # the zero state is fixed


@pytest.mark.parametrize("top", [2**16, 2**30])
def test_jump_matches_ulcx(top):
    rng = np.random.default_rng(top)
    seeds = _seeds(rng, 256)
    counts = rng.integers(0, top + 1, 256)
    counts[3] = top
    want = jax.jit(jrj.jump)(jnp.asarray(seeds), jnp.asarray(counts.astype(np.uint32)))
    got = trj.jump(torch.from_numpy(seeds.view(np.int32)), torch.from_numpy(counts))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


@pytest.mark.parametrize("kind", ["real", "synthetic"])
def test_draw_counts_match_ulcx(stream, kind):
    """Real flags (the stream's first blocks, as ulcx places them) and
    synthetic ones; the RNG-expand walk's new state is the seed jumped
    by the count."""
    rng = np.random.default_rng(31)
    if kind == "real":
        offs = np.cumsum(np.r_[0, _sequential_bytes(stream)[:3]])
        windows = np.stack([stream[o: o + WIN] for o in offs])
        rec, code, *_ = jfd.fsm_records(jnp.asarray(windows), CFG, interpret=True)
        flags = np.array(jfd.records_to_flags(rec, code, C * N))  # [B, P]
    else:
        flags = synthetic_flags(rng, C * N, 6).T.copy()
    want = np.asarray(jax.jit(jfd.draw_counts)(jnp.asarray(flags)))
    got = tfd.draw_counts(torch.from_numpy(flags))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).any()
    seeds = _seeds(rng, flags.shape[0])
    _, new_seed = dk.rng_expand_plain(torch.from_numpy(flags.T.copy()),
                                      torch.from_numpy(seeds.view(np.int32)))
    jumped = trj.jump(torch.from_numpy(seeds.view(np.int32)), got)
    assert torch.equal(new_seed, jumped)


def _sequential_bytes(stream):
    _, bits, _, _ = jax.jit(lambda s: jdec.decode_stream(s, T, WIN, CFG))(jnp.asarray(stream))
    return (np.asarray(bits) + 7) // 8


def _same_results(got, want, pcm_rel=REL):
    pcm, bits, corrupt, off, carry = got
    w_pcm, w_bits, w_corrupt, w_off, w_carry = want
    np.testing.assert_array_equal(bits, w_bits)
    np.testing.assert_array_equal(corrupt, w_corrupt)
    assert off == w_off
    assert _u32(carry.rng) == _u32(w_carry.rng)
    assert int(carry.prev_last_ss) == int(w_carry.prev_last_ss)
    assert _rel(pcm, w_pcm) < pcm_rel
    np.testing.assert_allclose(carry.lap, np.asarray(w_carry.lap), atol=LAP)


def test_pipelined_matches_decode_stream(pipelined, sequential):
    _same_results(pipelined, sequential)
    assert not pipelined[2].any()
    assert pipelined[0].shape == (T, C, N) and np.isfinite(pipelined[0]).all()


def test_pipelined_matches_ulcx(stream, pipelined):
    pcm, bits, corrupt, (off, carry) = jax.jit(
        lambda s: jdec.decode_stream_pipelined(s, T, WIN, CFG, interpret=True))(jnp.asarray(stream))
    want = (np.asarray(pcm), np.asarray(bits), np.asarray(corrupt), int(off),
            jax.tree_util.tree_map(np.asarray, carry))
    _same_results(pipelined, want)
    # the stream draws: its RNG state moved past the seed
    assert _u32(pipelined[4].rng) != dk.SEED


def test_pipelined_chained_continuation(stream, pipelined):
    """Two calls of T/2 blocks chained through (offset, carry) give the
    one call's results; the second half's entry seed comes from the
    first half's draws."""
    a = tdec.decode_stream_pipelined(torch.from_numpy(stream), T // 2, WIN, TCFG, device="cpu")
    off, carry = a[3]
    b = tdec.decode_stream_pipelined(torch.from_numpy(stream), T // 2, WIN, TCFG, offset=off,
                                     carry=carry, device="cpu")
    pcm = np.concatenate([a[0].numpy(), b[0].numpy()])
    np.testing.assert_array_equal(np.concatenate([a[1].numpy(), b[1].numpy()]), pipelined[1])
    np.testing.assert_allclose(pcm, pipelined[0], atol=1e-5)
    assert int(b[3][0]) == pipelined[3]
    assert _u32(b[3][1].rng.numpy()) == _u32(pipelined[4].rng)
    assert _u32(carry.rng.numpy()) != dk.SEED  # the first half drew


@pytest.mark.parametrize("delta", [1, 3])
def test_pipelined_unaligned_window(stream, sequential, delta):
    _same_results(_port(stream, win=WIN + delta), sequential)


def test_pipelined_corrupt_flagging(stream):
    """Garbage bytes mid-stream: the pipelined decoder flags corrupt where
    decode_stream does, up to and including the first corrupt block."""
    bad = stream.copy()
    bad[20:40] = 0xFF
    _, _, c_seq, _ = tdec.decode_stream(torch.from_numpy(bad), T, WIN, TCFG, device="cpu")
    got = _port(bad)[2]
    cs = c_seq.numpy()
    assert cs.any()
    first = int(cs.argmax())
    np.testing.assert_array_equal(got[: first + 1], cs[: first + 1])


def test_pipelined_off_is_identical(stream, pipelined):
    """use_pallas="off" runs the plain walks; on the CPU the kernels'
    wrappers run them too, so everything is identical."""
    off_cfg = TCodecConfig(**{**KW, "use_pallas": "off"})
    pcm, bits, corrupt, (off, carry) = tdec.decode_stream_pipelined(
        torch.from_numpy(stream), T, WIN, off_cfg, device="cpu")
    np.testing.assert_array_equal(pcm.numpy(), pipelined[0])
    np.testing.assert_array_equal(bits.numpy(), pipelined[1])
    np.testing.assert_array_equal(corrupt.numpy(), pipelined[2])
    assert int(off) == pipelined[3]
    assert _u32(carry.rng.numpy()) == _u32(pipelined[4].rng)
