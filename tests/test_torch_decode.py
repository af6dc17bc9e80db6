"""The decode slice end to end: the port's decoder against ulcx's.

The reference is ulcx with use_pallas="on", its kernels in interpret
mode (on the CPU, "auto" would take the scan decoder, whose PCM differs
by up to 2e-5). On the same bytes, records, flags, consumed bits,
corrupt flags and coefficients must be identical; PCM goes through
float32 DCT products whose summation order differs between XLA and
torch, so it is held to 1e-5 RMS (ROADMAP "Decoder" bound) and the
inverse transform to 1e-5 of the block's largest magnitude.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_decode_kernels import (
    CFG, C, N, P, W, block_windows, encoded_streams, fuzz_windows, pack_streams,
)
from ulcx.bitstream import fast_decode as jfd
from ulcx.codec import decoder as jdec
from ulcx.codec import transform_batched as jtb
from ulcx.codec.encoder import encode_stream_batched
from ulcx.parallel.mesh import batch_decode as j_batch_decode
from ulcx.utils.config import CodecConfig
from ulcx_torch._build import launch_counts, reset_launch_counts
from ulcx_torch.bitstream import decode_kernels as dk
from ulcx_torch.bitstream import fast_decode as tfd
from ulcx_torch.codec import decoder as tdec
from ulcx_torch.codec import transform_batched as ttb
from ulcx_torch.parallel.mesh import batch_decode
from ulcx_torch.utils.config import CodecConfig as TCodecConfig

T = 4
TCFG = TCodecConfig(rate_hz=44100, n_chan=C, block_size=N, use_pallas="on")  # CFG's, for the port
PCM_RMS = 1e-5  # f32 summation order of the DCT products (XLA vs torch)


@pytest.fixture(scope="module")
def enc():
    return encoded_streams()


@pytest.fixture(scope="module")
def fuzz():
    return fuzz_windows()


def _ulcx_decode_block(windows):
    out = jax.jit(lambda w: jfd.decode_block_fast(
        w, jnp.full(w.shape[0], 1234567, jnp.uint32), CFG, interpret=True))(jnp.asarray(windows))
    return [np.asarray(o) for o in out]


def _port_decode_block(windows):
    seed = torch.full((windows.shape[0],), 1234567, dtype=torch.int32)
    return tfd.decode_block_fast(torch.from_numpy(windows), seed, TCFG)


def test_fsm_records_and_flags_match_ulcx(enc, fuzz):
    """Records, header and flags of real and garbage windows; the flags
    against ulcx's one-hot matmul placement. ulcx's record word holds the
    start in 15 bits and the port's in 23, so records compare by field."""
    _, streams, offs, _ = enc
    windows = np.concatenate([block_windows(streams, offs, W), fuzz])
    want = jax.jit(lambda w: jfd.fsm_records(w, CFG, interpret=True))(jnp.asarray(windows))
    got = tfd.fsm_records(torch.from_numpy(windows), TCFG)
    w_rec, g_rec = np.asarray(want[0]), got[0].numpy()
    np.testing.assert_array_equal(g_rec & dk.REC_START_MASK, w_rec & 0x7FFF, err_msg="start")
    np.testing.assert_array_equal(g_rec >> dk.REC_START_BITS, w_rec >> 15, err_msg="type")
    for name, w, g in zip(("code", "wc", "hdr", "consumed", "corrupt"), want[1:], got[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert P % 128 == 0  # ulcx places by matmul at this size
    want_flags = np.asarray(jfd.records_to_flags(want[0], want[1], P))
    got_flags = tfd.records_to_flags(got[0], got[1], P)
    np.testing.assert_array_equal(got_flags.numpy(), want_flags)
    rtype = (got[0].numpy() >> dk.REC_START_BITS) & 7
    assert all((rtype == k).any() for k in (1, 2, 3, 4))  # every record type occurs


def test_expand_coefs_matches_ulcx(enc):
    _, streams, offs, _ = enc
    windows = jnp.asarray(block_windows(streams, offs, W))
    rec, code, *_ = jfd.fsm_records(windows, CFG, interpret=True)
    flags = jfd.records_to_flags(rec, code, P)
    seeds = np.random.default_rng(5).integers(0, 2**32, flags.shape[0], dtype=np.uint64)
    seeds = seeds.astype(np.uint32) | np.uint32(1 << 31)
    w_coef, w_seed = jfd.expand_coefs(flags, jnp.asarray(seeds), P, interpret=True)
    g_coef, g_seed = tfd.expand_coefs(torch.from_numpy(np.asarray(flags)),
                                      torch.from_numpy(seeds.view(np.int32)), P)
    np.testing.assert_array_equal(g_coef.numpy().view(np.uint32), np.asarray(w_coef).view(np.uint32))
    np.testing.assert_array_equal(g_seed.numpy().view(np.uint32), np.asarray(w_seed))


def test_decode_block_fast_matches_ulcx(enc):
    _, streams, offs, _ = enc
    windows = block_windows(streams, offs, W)
    coefs, wc, bits, corrupt, seed = _ulcx_decode_block(windows)
    g = _port_decode_block(windows)
    np.testing.assert_array_equal(g[0].numpy().view(np.uint32), coefs.view(np.uint32))
    for name, w, gg in zip(("wc", "bits", "corrupt"), (wc, bits, corrupt), g[1:4]):
        np.testing.assert_array_equal(gg.numpy(), w, err_msg=name)
    np.testing.assert_array_equal(g[4].numpy().view(np.uint32), seed)
    assert not corrupt.any()


@pytest.mark.parametrize("n", [256, 1024, 2048])
def test_block_imdct_batched_matches(n):
    """All 16 patterns x every transient scale class x every previous
    last-subblock size (0 at a stream's start), random coefs and laps."""
    kw = dict(rate_hz=44100, n_chan=C, block_size=n)
    cfg, tcfg = CodecConfig(**kw), TCodecConfig(**kw)
    rng = np.random.default_rng(n)
    prev = np.array([0, n, n // 2, n // 4, n // 8], np.int32)
    pats, prevs = np.meshgrid(np.arange(16), prev, indexing="ij")
    b = pats.size
    wc = (pats.ravel() << 4 | rng.integers(0, 8, b)).astype(np.int32)
    prev_ss = prevs.ravel().astype(np.int32)
    coefs = rng.standard_normal((b, C, n)).astype(np.float32)
    lap = rng.standard_normal((b, C, n // 2)).astype(np.float32)
    want = jax.jit(lambda *a: jtb.block_imdct_batched(*a, cfg))(
        jnp.asarray(coefs), jnp.asarray(wc), jnp.asarray(lap), jnp.asarray(prev_ss))
    want = [np.asarray(w) for w in want]
    got = ttb.block_imdct_batched(torch.from_numpy(coefs), torch.from_numpy(wc),
                                  torch.from_numpy(lap), torch.from_numpy(prev_ss), tcfg)
    for name, g, w in zip(("pcm", "lap"), got[:2], want[:2]):
        scale = np.abs(w).max(axis=(1, 2), keepdims=True)
        assert (np.abs(g.numpy() - w) <= 1e-5 * scale).all(), name
    np.testing.assert_array_equal(got[2].numpy(), want[2])


def test_imdct_lap_runs_plain_on_cpu():
    """On CPU tensors the inverse transform's wrapper runs its plain
    version with the caller's transforms and launches nothing, whatever
    use_pallas says; the plain version is the class GEMMs and
    ``imdct_lap_plain``; the kernel's table holds the parts it reads, in
    its order."""
    rng = np.random.default_rng(7)
    b = 16
    wc = torch.from_numpy((np.arange(b) << 4 | rng.integers(0, 8, b)).astype(np.int32))
    prev = torch.from_numpy(rng.choice([0, N, N // 2, N // 4, N // 8], b).astype(np.int32))
    coefs = torch.from_numpy(rng.standard_normal((b, C, N)).astype(np.float32))
    lap = torch.from_numpy(rng.standard_normal((b, C, N // 2)).astype(np.float32))
    reset_launch_counts()
    got = ttb.block_imdct_batched(coefs, wc, lap, prev, TCFG)
    off = ttb.block_imdct_batched(coefs, wc, lap, prev, TCodecConfig(rate_hz=44100, n_chan=C,
                                                                      block_size=N,
                                                                      use_pallas="off"))
    wrapped = ttb.imdct(coefs, wc, lap, prev, TCFG.transform_for)
    assert launch_counts("imdct") == {"imdct": 0}
    plain = ttb.imdct_lap_plain(ttb.class_halfspecs(coefs, TCFG.transform_for), wc, lap, prev)
    for g, w, x, y in zip(got, off, wrapped, plain):
        assert torch.equal(g, w) and torch.equal(g, x) and torch.equal(g, y)
    # a direct call takes the caller's DCT-IV backend, as block_imdct_batched does
    fft = TCodecConfig(rate_hz=44100, n_chan=C, block_size=N, transform_backend="fft")
    for g, w in zip(ttb.imdct(coefs, wc, lap, prev, fft.transform_for),
                    ttb.block_imdct_batched(coefs, wc, lap, prev, fft)):
        assert torch.equal(g, w)
    tables = ttb.lap_tables(N, torch.device("cpu"))
    t = ttb.device_tables(N, torch.device("cpu"))
    assert tables.dtype == torch.int32 and tables.numel() == 4 * 16 * 15 + 16 + 16 + 15
    parts = torch.split(tables, [t[k].numel() for k in ttb.LAP_TABLE_PARTS])
    for k, part in zip(ttb.LAP_TABLE_PARTS, parts):
        assert torch.equal(part, t[k].reshape(-1).to(torch.int32)), k
    assert ttb.imdct_geometry(b, C, N) == {"threads": 256, "shared": 8 * (N // 2 + N // 64) + 2 * N}
    with pytest.raises(ValueError):
        ttb.imdct_geometry(0, C, N)


@pytest.mark.parametrize("c", [1, 2, 3, 5])
def test_inverse_ms_and_nybbles_match(c):
    rng = np.random.default_rng(c)
    x = rng.standard_normal((3, 2, c, 16)).astype(np.float32)
    np.testing.assert_array_equal(tdec.inverse_ms(torch.from_numpy(x)).numpy(),
                                  np.asarray(jdec.inverse_ms(jnp.asarray(x))))
    by = rng.integers(0, 256, (c, 9)).astype(np.uint8)
    np.testing.assert_array_equal(tdec.bytes_to_nybbles(torch.from_numpy(by)).numpy(),
                                  np.asarray(jdec.bytes_to_nybbles(jnp.asarray(by))))


def _vbr_streams(x):
    out, _ = jax.jit(lambda b: encode_stream_batched(b, CFG, "vbr", quality=50.0))(jnp.asarray(x))
    sizes, data = np.asarray(out.size_bits), np.asarray(out.data)
    return pack_streams(sizes, data, 1024)[0], sizes


@pytest.mark.parametrize("mode", ["cbr", "vbr"])
def test_batch_decode_matches_ulcx(enc, mode):
    x, streams, _, sizes = enc
    if mode == "vbr":
        streams, sizes = _vbr_streams(x)
    win = -(-int(sizes.max() // 8) // 64) * 64 + 64  # as bench.py sizes it
    pcm, bits, corrupt = jax.jit(lambda s: j_batch_decode(s, T, win, CFG))(jnp.asarray(streams))
    g_pcm, g_bits, g_corrupt = batch_decode(torch.from_numpy(streams), T, win, TCFG, device="cpu")
    np.testing.assert_array_equal(g_bits.numpy(), np.asarray(bits))
    np.testing.assert_array_equal(g_corrupt.numpy(), np.asarray(corrupt))
    assert not g_corrupt.any()
    assert ((g_bits.numpy() + 7) // 8 * 8 == sizes).all()
    rms = np.sqrt(np.mean((g_pcm.numpy() - np.asarray(pcm)) ** 2))
    assert rms <= PCM_RMS, rms
    assert g_pcm.shape == (x.shape[0], T, C, N)


def test_fuzz_decode_block_matches_ulcx(fuzz):
    """Garbage and mutated windows: corrupt flags and bits agree on every
    window, coefficients on the clean ones, and the port's PCM stays
    finite, corrupt or not."""
    coefs, wc, bits, corrupt, _ = _ulcx_decode_block(fuzz)
    g_coefs, g_wc, g_bits, g_corrupt, _ = _port_decode_block(fuzz)
    np.testing.assert_array_equal(g_corrupt.numpy(), corrupt)
    np.testing.assert_array_equal(g_bits.numpy(), bits)
    clean = ~corrupt
    assert 8 <= clean.sum() < len(clean)
    np.testing.assert_array_equal(g_coefs.numpy()[clean].view(np.uint32),
                                  coefs[clean].view(np.uint32))
    b = fuzz.shape[0]
    carry = tdec.DecoderCarry.init(TCFG, b, "cpu")
    pcm, _, _ = ttb.block_imdct_batched(g_coefs, g_wc, carry.lap, carry.prev_last_ss, TCFG)
    assert torch.isfinite(tdec.inverse_ms(pcm)).all()
