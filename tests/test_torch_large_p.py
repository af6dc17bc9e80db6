"""Past P = 32768: 32 channels x bs2048 (P = 65,536) against ulcx.

ulcx's kernels stop at P = 32768 (their words keep a position in 15-16
bits), so above it ulcx takes its scan path; the port runs the same
walks there with wider words. One stream of two blocks, its energy in
the last 16 channels (the first 16 attenuated 60 dB) so that coded
coefficients, next-coded positions and decoded record starts lie past
32768; the tests assert that they do.

- From ulcx's own ``prepare_fast`` output the port's size rounds and
  materialized bytes equal ulcx's scan path (``encode_pass_size`` /
  ``encode_pass_materialize(prepare_block(blk), n, ..., "segment")``)
  exactly, the contract tests/test_pallas_encode.py holds below P =
  32768.
- ``batch_encode`` against ulcx's (its scan path): window control and
  coded counts exact, total size within 1 %, round-trip SNR within
  0.3 dB.
- On ulcx's bytes, the port's decode against ulcx's scan decoder: bits,
  corrupt flags and coefficients exact, PCM within 2e-5 RMS (the gap
  between ulcx's kernel and scan decoders).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax

from bench import make_corpus
from ulcx.analysis.batched import analyze_block_batched as j_analyze
from ulcx.bitstream import encode as jenc
from ulcx.bitstream import fast_encode as jfe
from ulcx.bitstream.decode import decode_block_tokens, expand_records
from ulcx.codec.decoder import bytes_to_nybbles
from ulcx.codec.encoder import init_carry_batched as j_init
from ulcx.parallel.mesh import batch_decode as j_batch_decode
from ulcx.parallel.mesh import batch_encode as j_batch_encode
from ulcx.utils.config import CodecConfig
from ulcx_torch.analysis.batched import analyze_block_batched as t_analyze
from ulcx_torch.bitstream import decode_kernels as dk
from ulcx_torch.bitstream import encode_kernels as ek
from ulcx_torch.bitstream import fast_decode as tfd
from ulcx_torch.bitstream import fast_encode as tfe
from ulcx_torch.codec.encoder import init_carry_batched as t_init
from ulcx_torch.codec.encoder import max_block_bytes
from ulcx_torch.parallel.mesh import batch_decode, batch_encode
from ulcx_torch.utils.config import CodecConfig as TCodecConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, C, T = 2048, 32, 2
P = N * C
KW = dict(rate_hz=44100, n_chan=C, block_size=N)
CFG, TCFG = CodecConfig(**KW), TCodecConfig(**KW)  # ulcx's, the port's
RATE = {"rate_kbps": 128.0}
BUDGET = int(N * 128.0 * 1000.0 / 44100.0)
MAX_BYTES = max_block_bytes(TCFG)
HALF = 32768
PCM_RMS = 2e-5


@pytest.fixture(scope="module")
def x():
    """[1, T, 32, N]: sixteen stereo corpus streams side by side as one
    32-channel stream, the first 16 channels 60 dB down."""
    s = make_corpus(16, T, N).astype(np.float32)  # [16, T, 2, N]
    s = s.transpose(1, 0, 2, 3).reshape(1, T, C, N).copy()
    s[:, :, : C // 2] *= 1e-3
    return s


@pytest.fixture(scope="module")
def analyzed(x):
    """ulcx's analysis of both blocks, stacked as a batch of two, and the
    coded counts of ulcx's and the port's analyses, [T]."""
    step = jax.jit(lambda c, b: j_analyze(c, b, CFG))
    carry, blks = j_init(CFG, 1), []
    for j in range(T):
        carry, blk = step(carry, jnp.asarray(x[:, j]))
        blks.append(blk)
    stacked = jax.tree_util.tree_map(lambda *b: jnp.concatenate(b), *blks)
    tcarry, n_nz = t_init(TCFG, 1, "cpu"), []
    for j in range(T):
        tcarry, blk = t_analyze(tcarry, torch.from_numpy(x[:, j]), TCFG)
        n_nz.append(int(blk.n_nz[0]))
    return stacked, np.asarray(stacked.n_nz), np.array(n_nz)


@pytest.fixture(scope="module")
def ulcx_encoded(x):
    out, _ = jax.jit(lambda b: j_batch_encode(b, CFG, "cbr", **RATE))(jnp.asarray(x))
    return np.asarray(out.size_bits), np.asarray(out.data), np.asarray(out.window_ctrl)


def _stream(sizes, data):
    """[1, S] bytes of one stream's blocks back to back, padded."""
    s = np.zeros((1, T * MAX_BYTES + MAX_BYTES + 64), np.uint8)
    off = 0
    for j in range(T):
        nb = int(sizes[0, j]) // 8
        s[0, off: off + nb] = data[0, j, :nb]
        off += nb
    return s


def _window(sizes):
    return -(-int(sizes.max() // 8) // 64) * 64 + 64  # as bench.py sizes it


def test_walks_match_ulcx_scan(analyzed):
    """Sizes of eight counts per block and the bytes of one, from ulcx's
    prepare_fast output, against ulcx's scan path; next coded positions
    past 32768 occur."""
    stacked, n_nz, _ = analyzed
    fb = jax.jit(lambda b: jfe.prepare_fast(b, CFG))(stacked)
    fbt = tfe.FastBlockData(*(torch.from_numpy(np.array(v)) for v in fb))
    frac = np.array([0.0, 0.05, 0.2, 0.4, 0.6, 0.8, 0.95, 1.0])
    nn = np.round(n_nz[:, None] * frac[None]).astype(np.int32)
    got = tfe.total_sizes(fbt, torch.from_numpy(nn), TCFG).numpy()
    n_out = nn[:, 4]
    g_size, g_bytes = tfe.materialize_fast(fbt, torch.from_numpy(n_out), TCFG, MAX_BYTES)

    size_f = jax.jit(jax.vmap(lambda bd, k: jenc.encode_pass_size(bd, k, "segment"),
                              in_axes=(None, 0)))
    mat_f = jax.jit(lambda bd, k: jenc.encode_pass_materialize(bd, k, MAX_BYTES, "segment"))
    for i in range(T):
        bd = jenc.prepare_block(jax.tree_util.tree_map(lambda v: v[i], stacked), CFG)
        np.testing.assert_array_equal(got[i], np.asarray(size_f(bd, jnp.asarray(nn[i]))))
        w_bits, w_bytes = mat_f(bd, jnp.int32(n_out[i]))
        assert int(g_size[i]) == int(w_bits)
        nb = int(w_bits) // 8
        assert g_bytes[i, :nb].numpy().tobytes() == np.asarray(w_bytes)[:nb].tobytes()

    state = tfe._state(tfe.make_planes(fbt), torch.from_numpy(nn), ek.KERNEL_WALKS)
    ncp = state & ek.NCP_MAX
    assert ((ncp >= HALF) & (ncp < ek.NCP_MAX)).any()
    assert (((state[HALF:] >> 29) & 1) == 1).any()  # coded past 32768


def test_batch_encode_matches_ulcx(x, analyzed, ulcx_encoded):
    _, n_nz_ulcx, n_nz_port = analyzed
    w_sizes, w_data, w_wc = ulcx_encoded
    got, stats = batch_encode(torch.from_numpy(x), TCFG, "cbr", device="cpu", **RATE)
    g_sizes, g_data = got.size_bits.numpy(), got.data.numpy()
    np.testing.assert_array_equal(got.window_ctrl.numpy(), w_wc)
    np.testing.assert_array_equal(n_nz_port, n_nz_ulcx)
    assert (g_sizes <= BUDGET).all()
    assert abs(int(g_sizes.sum()) - int(w_sizes.sum())) <= 0.01 * int(w_sizes.sum())
    assert int(stats["total_bits"]) == int(g_sizes.sum())

    decode = jax.jit(lambda s, w: j_batch_decode(s, T, w, CFG), static_argnums=1)
    win = _window(np.maximum(g_sizes, w_sizes))
    snrs = []
    for sizes, data in ((g_sizes, g_data), (w_sizes, w_data)):
        pcm, _, corrupt = decode(jnp.asarray(_stream(sizes, data)), win)
        assert not np.asarray(corrupt).any()
        want = x[:, : T - 1]
        err = np.asarray(pcm)[:, 1:] - want
        snrs.append(10 * np.log10((want ** 2).sum() / (err ** 2).sum()))
    assert abs(snrs[0] - snrs[1]) <= 0.3, snrs


def _ulcx_coefs(window, rng):
    """ulcx's scan decoder's coefficients of one block (its decode_block
    up to the inverse transform)."""
    nyb = bytes_to_nybbles(window)
    wc = nyb[0]
    has2 = (wc & 0x8) != 0
    wc = jnp.where(has2, wc | (nyb[1] << 4), wc | (1 << 4)).astype(jnp.int32)
    hdr = jnp.where(has2, 2, 1).astype(jnp.int32)
    tokens = lax.dynamic_slice(nyb, (hdr,), (nyb.shape[0] - 2,))
    records, _, corrupt = decode_block_tokens(tokens, wc, CFG)
    flat, rng = expand_records(records, rng, P)
    return jnp.where(corrupt, 0.0, flat), rng


def test_decode_matches_ulcx_scan(ulcx_encoded):
    """On ulcx's bytes: bits, corrupt flags, PCM against ulcx's
    batch_decode (its scan decoder at this P); each block's coefficients
    against ulcx's scan expansion, bit for bit; records start past
    32768."""
    sizes, data, _ = ulcx_encoded
    streams = _stream(sizes, data)
    win = _window(sizes)
    pcm, bits, corrupt = jax.jit(lambda s: j_batch_decode(s, T, win, CFG))(jnp.asarray(streams))
    g_pcm, g_bits, g_corrupt = batch_decode(torch.from_numpy(streams), T, win, TCFG, device="cpu")
    np.testing.assert_array_equal(g_bits.numpy(), np.asarray(bits))
    np.testing.assert_array_equal(g_corrupt.numpy(), np.asarray(corrupt))
    assert not g_corrupt.any() and ((g_bits.numpy() + 7) // 8 * 8 == sizes).all()
    rms = np.sqrt(np.mean((g_pcm.numpy() - np.asarray(pcm)) ** 2))
    assert rms <= PCM_RMS, rms

    coefs_f = jax.jit(_ulcx_coefs)
    offs = np.r_[0, np.cumsum(sizes[0] // 8)[:-1]]
    windows = np.stack([streams[0, o: o + win] for o in offs])
    seed, j_seed = torch.tensor([dk.SEED], dtype=torch.int32), jnp.uint32(dk.SEED)
    for j in range(T):
        g_coef, _, _, g_bad, seed = tfd.decode_block_fast(torch.from_numpy(windows[j: j + 1]),
                                                          seed, TCFG)
        w_coef, j_seed = coefs_f(jnp.asarray(windows[j]), j_seed)
        assert not bool(g_bad.any())
        np.testing.assert_array_equal(g_coef.numpy().reshape(-1).view(np.uint32),
                                      np.asarray(w_coef).view(np.uint32))
        assert int(seed.numpy().view(np.uint32)[0]) == int(j_seed)
    rec = tfd.fsm_records(torch.from_numpy(windows), TCFG)[0].numpy()
    starts = (rec & dk.REC_START_MASK)[(rec >> dk.REC_START_BITS) != dk.REC_NONE]
    assert (starts >= HALF).any() and starts.max() < P
