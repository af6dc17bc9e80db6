"""ulcx's scan path in the port: its route, its exact rate search, and
its single-block encode and decode forms, against ulcx.

ulcx codes a bitstream batch on its kernel path's plan (the seeded
ladder) only where its kernels run (``ulcx.codec.encoder._use_kernel``),
and everywhere else on its scan path's: the exact 16-candidate ladder
(``_cbr_search_ladder``) or the bisection. The port follows the same
route (without ulcx's CPU clause) on the same walks.

- Multichannel streams (8 and 16 channels) are coded by ulcx on its
  scan path at every batch here; the port must give window control and
  coded counts exactly, every block within its budget (or, where no
  count fits, at the size of no coded coefficient), the total within
  1 % and the round-trip SNR within 0.3 dB. The seeded plan fell 2.8 to
  5.7 % short at these shapes.
- The route against ulcx's own ``_use_kernel`` (its backend made "tpu"
  here), and the batch each encode form routes with.
- From ulcx's ``prepare_fast`` output, the port's scan-plan counts equal
  ulcx's ``_cbr_search_ladder(prepare_block(blk))`` and its bytes
  ``encode_pass_materialize`` at that count, for both noise windows
  (bs256 stereo ``synth_block`` blocks, P = 512); the port's
  ``bitstream.encode`` equals ulcx's.
- ``analyze_block``, ``encode_analyzed_*`` and ``encode_block`` against
  ulcx's (decisions exact, floats and sizes within the repo's bounds).
- ``decode_block_tokens`` Records (emit, type, start, count exact; level
  and decay as bits), ``expand_records`` (coefficients as bits, RNG
  state exact) and ``decode_block`` against ulcx's, on the encoder's
  windows and on random, half-random and truncated ones; ``decode_block``
  also equals the port's ``decode_stream``.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bench import make_corpus
from chip_smoke import multichannel
from test_encode_pass import synth_block
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from ulcx.analysis import block as jblock
from ulcx.analysis.batched import analyze_block_batched as j_analyze
from ulcx.bitstream import decode as jdecode
from ulcx.bitstream import encode as jenc
from ulcx.bitstream import fast_encode as jfe
from ulcx.codec import decoder as jdec
from ulcx.codec import encoder as jencoder
from ulcx.parallel.mesh import batch_encode as j_batch_encode
from ulcx.utils.config import CodecConfig
from ulcx_torch.analysis import block as tblock
from ulcx_torch.analysis.batched import analyze_block_batched as t_analyze
from ulcx_torch.bitstream import decode as tdecode
from ulcx_torch.bitstream import encode as tenc_pass
from ulcx_torch.bitstream import fast_encode as tfe
from ulcx_torch.bitstream.fast_decode import _header_and_tokens
from ulcx_torch.codec import decoder as tdec
from ulcx_torch.codec import encoder as tenc
from ulcx_torch.parallel.mesh import batch_decode, batch_encode
from ulcx_torch.utils.config import CodecConfig as TCodecConfig

RATE_HZ = 44100
# the multichannel shapes: (channels, block size, CBR kbps, B, T)
SHAPES = {
    "8ch_bs256_cbr32": (8, 256, 32.0, 2, 2),
    "16ch_bs256_cbr32": (16, 256, 32.0, 2, 2),
    "16ch_bs2048_cbr128": (16, 2048, 128.0, 1, 2),
}
N, C = 256, 2
P = N * C
KW = dict(rate_hz=RATE_HZ, n_chan=C, block_size=N)
MAX_BYTES = 2 * P
WCS = [0x10, 0x28, 0x59, 0xFB, 0x3A, 0x6C, 0x8B, 0x10]
MODES = {
    "cbr": {"rate_kbps": 128.0},
    "abr": {"rate_kbps": 128.0, "avg_complexity": 0.5},
    "vbr": {"quality": 50.0},
}
PCM_RMS = 1e-5


def _budget(n, kbps):
    return int(tenc.cbr_bit_budget(TCodecConfig(rate_hz=RATE_HZ, block_size=n), kbps))


def _pack(sizes, data, win):
    """[B, T] blocks -> [B, S] byte streams, each block after the last."""
    b, t = sizes.shape
    streams = np.zeros((b, t * win + win + 64), np.uint8)
    for i in range(b):
        off = 0
        for j in range(t):
            nb = int(sizes[i, j]) // 8
            streams[i, off: off + nb] = data[i, j, :nb]
            off += nb
    return streams


# ---------------------------------------------------------------------------
# the fault: multichannel streams on ulcx's scan path


@pytest.mark.parametrize("shape", list(SHAPES))
def test_batch_encode_matches_ulcx_multichannel(shape):
    c, n, kbps, b, t = SHAPES[shape]
    kw = dict(rate_hz=RATE_HZ, n_chan=c, block_size=n)
    cfg, tcfg = CodecConfig(**kw), TCodecConfig(**kw)
    x = multichannel(b, t, c, n).astype(np.float32)
    want, _ = jax.jit(lambda v: j_batch_encode(v, cfg, "cbr", rate_kbps=kbps))(jnp.asarray(x))
    got, _ = batch_encode(torch.from_numpy(x), tcfg, "cbr", device="cpu", rate_kbps=kbps)
    w_sizes, w_data = np.asarray(want.size_bits), np.asarray(want.data)
    g_sizes, g_data = got.size_bits.numpy(), got.data.numpy()
    np.testing.assert_array_equal(got.window_ctrl.numpy(), np.asarray(want.window_ctrl))

    # coded counts of both analyses, and each block's size at no coded
    # coefficient (its least: where no count fits, the search lands there)
    step = jax.jit(lambda cr, blk: j_analyze(cr, blk, cfg))
    jc, tc = jencoder.init_carry_batched(cfg, b), tenc.init_carry_batched(tcfg, b, "cpu")
    floor = np.zeros((b, t), np.int64)
    for j in range(t):
        jc, jb = step(jc, jnp.asarray(x[:, j]))
        tc, tb = t_analyze(tc, torch.from_numpy(x[:, j]), tcfg)
        np.testing.assert_array_equal(tb.n_nz.numpy(), np.asarray(jb.n_nz))
        fb = tfe.prepare_fast(tb, tcfg)
        floor[:, j] = tenc_pass.encode_pass_size(fb, torch.zeros(b, dtype=torch.int32),
                                                 "segment").numpy()
    budget = _budget(n, kbps)
    assert ((g_sizes <= budget) | (g_sizes == floor)).all(), (g_sizes, floor)
    g_tot, w_tot = int(g_sizes.sum()), int(w_sizes.sum())
    assert abs(g_tot - w_tot) <= 0.01 * w_tot, (g_tot, w_tot)

    # both packages' bytes through the port's decoder, as one batch
    win = 2 * c * n
    streams = np.concatenate([_pack(g_sizes, g_data, win), _pack(w_sizes, w_data, win)])
    pcm, _, corrupt = batch_decode(torch.from_numpy(streams), t, win, tcfg, device="cpu")
    assert not corrupt.any()
    err = pcm.numpy()[:, 1:] - np.concatenate([x, x])[:, : t - 1]
    ref = (x[:, : t - 1] ** 2).sum()
    snr = [10 * np.log10(ref / (e ** 2).sum()) for e in (err[:b], err[b:])]
    assert abs(snr[0] - snr[1]) <= 0.3, snr


# ---------------------------------------------------------------------------
# the route


@pytest.mark.parametrize("window", ["segment", "gap"])
@pytest.mark.parametrize("use_pallas", ["auto", "on", "off"])
def test_route_matches_ulcx(monkeypatch, use_pallas, window):
    """Over batches 3, 8, 13, P = 512 and 65,536, and the batch each
    encode form routes with (the block loop B, fold_bitstream=2 2B,
    flat_stream with T = 4 4B): "auto" and "off" exactly ulcx's route;
    "on" ulcx's inside its envelope, and outside it, where ulcx raises,
    the kernel path's plan up to P = 32768 and the scan path's above."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for c, n in ((2, 256), (32, 2048)):
        kw = dict(rate_hz=RATE_HZ, n_chan=c, block_size=n, noise_run_window=window,
                  use_pallas=use_pallas)
        if window == "gap" and use_pallas == "on":
            for make in (CodecConfig, TCodecConfig):
                with pytest.raises(ValueError):
                    make(**kw)
            continue
        cfg, tcfg = CodecConfig(**kw), TCodecConfig(**kw)
        for b in (3, 8, 13):
            for batch in (b, 2 * b, 4 * b):
                got = tenc._use_kernel(tcfg, batch)
                try:
                    want = jencoder._use_kernel(cfg, batch)
                except ValueError:
                    assert use_pallas == "on"
                    want = c * n <= 32768
                assert got == want, (c, n, batch)


def test_encode_forms_route_on_their_bitstream_batch(monkeypatch):
    """The batch each encode form hands the route: the block loop B a block,
    fold_bitstream=2 2B a chunk, flat_stream B*T once, encode_stream T."""
    seen = []
    inner = tenc._use_kernel

    def record(cfg, batch):
        seen.append(batch)
        return inner(cfg, batch)

    monkeypatch.setattr(tenc, "_use_kernel", record)
    x = torch.from_numpy(make_corpus(3, 4, N))
    cfg = TCodecConfig(**KW)
    for change, want in (({}, [3] * 4), ({"fold_bitstream": 2}, [6] * 2),
                         ({"flat_stream": True}, [12])):
        seen.clear()
        tenc.encode_stream_batched(x, TCodecConfig(**KW, **change), "vbr", quality=50.0)
        assert seen == want, change
    seen.clear()
    tenc.encode_stream(x[0], cfg, "vbr", device="cpu", quality=50.0)
    assert seen == [4]


# ---------------------------------------------------------------------------
# the exact ladder and the encode pass, from ulcx's walk inputs


@functools.lru_cache(maxsize=2)
def _walk_inputs(window):
    """Eight synthetic analyzed blocks: (the ulcx config, each block,
    each block's BlockData, the port's FastBlockData from ulcx's
    prepare_fast, with prepare_block's cw and cwy under gap)."""
    cfg = CodecConfig(**KW, noise_run_window=window)
    rng = np.random.default_rng(41)
    blks = [synth_block(rng, wc, sparsity=float(rng.uniform(0.2, 0.8)))[0] for wc in WCS]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *blks)
    fb = jfe.prepare_fast(stacked, cfg)
    bds = [jenc.prepare_block(blk, cfg) for blk in blks]
    gap = {}
    if window == "gap":
        gap = {k: torch.from_numpy(np.stack([np.asarray(getattr(bd, k)) for bd in bds]))
               for k in ("cw", "cwy")}
    fbt = tfe.FastBlockData(*(torch.from_numpy(np.array(v)) for v in fb), **gap)
    return cfg, blks, bds, fbt


@functools.partial(jax.jit, static_argnums=(3,))
def _j_ladder(bd, n_nz, budget, cfg):
    return jencoder._cbr_search_ladder(bd, n_nz, budget, cfg)


@functools.partial(jax.jit, static_argnums=(2,))
def _j_materialize(bd, n, window):
    return jenc.encode_pass_materialize(bd, n, MAX_BYTES, window)


@pytest.mark.parametrize("window", ["segment", "gap"])
@pytest.mark.parametrize("kbps", [48.0, 128.0, 320.0])
def test_ladder_matches_cbr_search_ladder(kbps, window):
    cfg, blks, bds, fbt = _walk_inputs(window)
    tcfg = TCodecConfig(**KW, noise_run_window=window)
    budget = int(N * kbps * 1000.0 / RATE_HZ)
    n_nz = torch.tensor([int(blk.n_nz) for blk in blks], dtype=torch.int32)
    n_out, size, data = tfe.search_materialize_scan(
        fbt, n_nz, torch.full((len(blks),), budget, dtype=torch.int32), tcfg, MAX_BYTES)
    for i, (blk, bd) in enumerate(zip(blks, bds)):
        want_n = int(_j_ladder(bd, blk.n_nz, jnp.int32(budget), cfg))
        assert int(n_out[i]) == want_n, i
        want_bits, want_by = _j_materialize(bd, jnp.int32(want_n), window)
        assert int(size[i]) == int(want_bits)
        nb = int(want_bits) // 8
        assert data[i, :nb].numpy().tobytes() == np.asarray(want_by)[:nb].tobytes()


@pytest.mark.parametrize("window", ["segment", "gap"])
def test_encode_pass_matches_ulcx(window):
    """The port's encode_pass_size / encode_pass_materialize (one count a
    stream, through the walks) equal ulcx's at five counts a block."""
    _, blks, bds, fbt = _walk_inputs(window)
    n_nz = np.array([int(blk.n_nz) for blk in blks])
    size_f = jax.jit(lambda bd, k: jenc.encode_pass_size(bd, k, window))
    for frac in (0.0, 0.1, 0.4, 0.8, 1.0):
        n = np.round(n_nz * frac).astype(np.int32)
        sizes = tenc_pass.encode_pass_size(fbt, torch.from_numpy(n), window)
        bits, by = tenc_pass.encode_pass_materialize(fbt, torch.from_numpy(n), MAX_BYTES, window)
        assert torch.equal(sizes, bits)
        for i, bd in enumerate(bds):
            assert int(sizes[i]) == int(size_f(bd, jnp.int32(n[i]))), (frac, i)
            w_bits, w_by = _j_materialize(bd, jnp.int32(n[i]), window)
            nb = int(w_bits) // 8
            assert by[i, :nb].numpy().tobytes() == np.asarray(w_by)[:nb].tobytes()
    with pytest.raises(ValueError, match="gap"):
        tenc_pass.encode_pass_size(fbt._replace(cw=None, cwy=None), torch.zeros(8), "gap")


# ---------------------------------------------------------------------------
# single-block encode forms


@pytest.fixture(scope="module")
def stream():
    return make_corpus(4, 3, N)[3]  # [3, C, N]; stream 3 has transients


@pytest.fixture(scope="module")
def ulcx_steps(stream):
    """ulcx's encode_block chain over the stream, CBR: [(carry,
    AnalyzedBlock, EncodedBlock)] after each block, leaves as numpy."""
    cfg = CodecConfig(**KW)

    def one(carry, x):
        carry, blk = jblock.analyze_block(carry, x, cfg)
        return carry, blk, jencoder._encode_analyzed(blk, cfg, "cbr", **MODES["cbr"])

    step = jax.jit(one)
    carry, out = jblock.EncoderCarry.init(cfg), []
    for j in range(stream.shape[0]):
        carry, blk, enc = step(carry, jnp.asarray(stream[j]))
        out.append(jax.tree_util.tree_map(np.asarray, (carry, blk, enc)))
    return out


def test_analyze_block_matches_ulcx(stream, ulcx_steps):
    """One stream's chain from a fresh carry: decisions exact, ulcx's
    unbatched leaves, floats to the transform's summation order (the
    bounds of tests/test_torch_analysis.py)."""
    tcfg = TCodecConfig(**KW)
    carry = tblock.map_leaves(lambda v: v[0], tenc.init_carry_batched(tcfg, 1, "cpu"))
    for j, (jcarry, jb, _) in enumerate(ulcx_steps):
        carry, tb = tblock.analyze_block(carry, torch.from_numpy(stream[j]), tcfg)
        for g, w in zip(tb, jb):
            assert tuple(g.shape) == w.shape
        assert int(tb.window_ctrl) == int(jb.window_ctrl) and int(tb.n_nz) == int(jb.n_nz)
        scale = np.abs(jb.mdct).max()
        assert np.abs(tb.mdct.numpy() - jb.mdct).max() < 1e-5 * scale
        np.testing.assert_array_equal(np.isneginf(tb.importance.numpy()), np.isneginf(jb.importance))
        assert abs(float(tb.complexity) - float(jb.complexity)) <= 1e-5
        back = tblock.carry_to_numpy(carry)
        for g, w in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jcarry)):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("mode", list(MODES))
def test_encode_analyzed_matches_ulcx(monkeypatch, ulcx_steps, mode):
    """From ulcx's own AnalyzedBlock of each block (single leaves, and the
    blocks as one batch, each block its single form's bytes): with
    ulcx's walk inputs (its prepare_fast, patched in) size and bytes
    exactly ulcx's encode_analyzed_*; with the port's own (float64
    prefix sums, which may flip a near-tie) window control exact and CBR
    within its budget."""
    cfg, tcfg = CodecConfig(**KW), TCodecConfig(**KW)
    blks = [jb for _, jb, _ in ulcx_steps]
    if mode == "cbr":
        want = [enc for _, _, enc in ulcx_steps]
    else:
        fn = {"abr": lambda blk: jencoder.encode_analyzed_abr(blk, 128.0, 0.5, cfg),
              "vbr": lambda blk: jencoder.encode_analyzed_vbr(blk, 50.0, cfg)}[mode]
        stacked = jax.tree_util.tree_map(lambda *v: jnp.stack(v), *blks)
        out = jax.tree_util.tree_map(np.asarray, jax.jit(jax.vmap(fn))(stacked))
        want = [jax.tree_util.tree_map(lambda v: v[i], out) for i in range(len(blks))]
    single = {"cbr": lambda blk: tenc.encode_analyzed_cbr(blk, 128.0, tcfg),
              "abr": lambda blk: tenc.encode_analyzed_abr(blk, 128.0, 0.5, tcfg),
              "vbr": lambda blk: tenc.encode_analyzed_vbr(blk, 50.0, tcfg)}[mode]
    tblks = [tblock.AnalyzedBlock(*(torch.from_numpy(np.array(v)) for v in jb)) for jb in blks]

    def check(exact):
        batch = tenc._encode_analyzed(tenc._stack(tblks, 0), tcfg, mode, **MODES[mode])
        for i, (w, tb) in enumerate(zip(want, tblks)):
            got = single(tb)
            assert got.data.shape == (MAX_BYTES,) and got.size_bits.shape == ()
            assert int(got.window_ctrl) == int(w.window_ctrl)
            if mode == "cbr":
                assert int(got.size_bits) <= _budget(N, 128.0)
            for name in ("size_bits", "data"):
                assert torch.equal(getattr(batch, name)[i], getattr(got, name)), name
            if exact:
                assert int(got.size_bits) == int(w.size_bits), i
                assert np.array_equal(got.data.numpy(), w.data), i

    check(exact=False)

    def ulcx_prepare(blk, _):
        fb = jfe.prepare_fast(jblock.AnalyzedBlock(*(jnp.asarray(v.numpy()) for v in blk)), cfg)
        return tfe.FastBlockData(*(torch.from_numpy(np.array(v)) for v in fb))

    monkeypatch.setattr(tenc, "prepare_fast", ulcx_prepare)
    check(exact=True)


def test_encode_block_matches_ulcx(stream, ulcx_steps):
    """Block steps of one stream from a fresh carry, CBR: window control
    exact, each block within its budget, the total within 1 % of ulcx's
    encode_block."""
    tcfg = TCodecConfig(**KW)
    tc = tblock.map_leaves(lambda v: v[0], tenc.init_carry_batched(tcfg, 1, "cpu"))
    g_tot = w_tot = 0
    for j, (_, _, want) in enumerate(ulcx_steps):
        tc, got = tenc.encode_block(tc, torch.from_numpy(stream[j]), tcfg, "cbr", **MODES["cbr"])
        assert got.size_bits.shape == () and tc.sample_prev.shape == (C, N)
        assert int(got.window_ctrl) == int(want.window_ctrl)
        assert int(got.size_bits) <= _budget(N, 128.0)
        g_tot, w_tot = g_tot + int(got.size_bits), w_tot + int(want.size_bits)
    assert abs(g_tot - w_tot) <= 0.01 * w_tot


# ---------------------------------------------------------------------------
# single-block decode forms


@pytest.fixture(scope="module")
def dec_windows():
    """{kind: windows [B, W] uint8}: the port's CBR-160 encode of eight
    random bs256 streams of four blocks (every block's window); random
    bytes; real windows with a random second half; real windows cut to
    48 bytes (~94 tokens, fewer than any block needs). And the packed
    streams of the encode."""
    rng = np.random.default_rng(0xC0DEC)
    x = rng.standard_normal((8, 4, C, N)).astype(np.float32) * 0.3
    x[:, 2, :, 40] += 1.0
    out, _ = batch_encode(torch.from_numpy(x), TCodecConfig(**KW), "cbr", device="cpu",
                          rate_kbps=160.0)
    sizes, data = out.size_bits.numpy(), out.data.numpy()
    win = 160
    streams = _pack(sizes, data, win)
    offs = np.concatenate([np.zeros((8, 1), np.int64), np.cumsum(sizes // 8, 1)[:, :-1]], 1)
    real = np.stack([streams[i, o: o + win] for i in range(8) for o in offs[i]])
    half = real[:8].copy()
    half[:, win // 2:] = rng.integers(0, 256, (8, win - win // 2))
    rand = rng.integers(0, 256, (16, win)).astype(np.uint8)
    return {"real": real, "random": rand, "half": half, "truncated": real[:8, :48].copy()}, \
        streams, win


def _ulcx_records(windows):
    """ulcx's decode_block_tokens of each window (header as its
    decode_block strips it): (Records [B, T], consumed [B], corrupt [B])
    as numpy."""
    cfg = CodecConfig(**KW)

    def one(w):
        nyb = jdec.bytes_to_nybbles(w)
        wc = nyb[0]
        has2 = (wc & 0x8) != 0
        wc = jnp.where(has2, wc | (nyb[1] << 4), wc | (1 << 4)).astype(jnp.int32)
        hdr = jnp.where(has2, 2, 1).astype(jnp.int32)
        tokens = jax.lax.dynamic_slice(nyb, (hdr,), (nyb.shape[0] - 2,))
        return jdecode.decode_block_tokens(tokens, wc, cfg)

    return jax.tree_util.tree_map(np.asarray, jax.jit(jax.vmap(one))(jnp.asarray(windows)))


def _port_records(windows):
    tcfg = TCodecConfig(**KW)
    wc, _, tokens = _header_and_tokens(torch.from_numpy(windows))
    return [tdecode.decode_block_tokens(tokens[:, i], wc[i], tcfg) for i in range(len(windows))]


@pytest.mark.parametrize("kind", ["real", "random", "half", "truncated"])
def test_decode_block_tokens_matches_ulcx(dec_windows, kind):
    windows = dec_windows[0][kind]
    (w_rec, w_consumed, w_corrupt) = _ulcx_records(windows)
    got = _port_records(windows)
    for i, (rec, consumed, corrupt) in enumerate(got):
        emit = w_rec.emit[i]
        assert torch.equal(rec.emit, torch.from_numpy(emit)), i
        for name in ("rtype", "start", "count"):
            np.testing.assert_array_equal(getattr(rec, name).numpy(), getattr(w_rec, name)[i],
                                          err_msg=f"{name} {i}")
        for name in ("level", "decay"):  # ulcx's only where a record is emitted
            want = np.where(emit, getattr(w_rec, name)[i], 0).astype(np.float32)
            np.testing.assert_array_equal(getattr(rec, name).numpy().view(np.uint32),
                                          want.view(np.uint32), err_msg=f"{name} {i}")
        assert int(consumed) == int(w_consumed[i]) and bool(corrupt) == bool(w_corrupt[i])
    corrupt = w_corrupt.astype(bool)
    if kind == "real":
        assert not corrupt.any()
    elif kind == "truncated":
        assert corrupt.all()
    else:
        assert corrupt.any()


@pytest.mark.parametrize("kind", ["real", "half"])
def test_expand_records_matches_ulcx(dec_windows, kind):
    """Coefficients as bits and the new state, from seeds with bit 31 set
    among them."""
    windows = dec_windows[0][kind]
    w_rec, _, _ = _ulcx_records(windows)
    seeds = np.random.default_rng(5).integers(0, 2**32, len(windows), dtype=np.uint64)
    seeds = seeds.astype(np.uint32)
    assert (seeds >= 2**31).any()
    j_expand = jax.jit(lambda r, s: jdecode.expand_records(r, s, P))
    for i, (rec, _, _) in enumerate(_port_records(windows)):
        w_coef, w_seed = j_expand(jax.tree_util.tree_map(lambda v: v[i], w_rec),
                                  jnp.uint32(seeds[i]))
        coef, seed = tdecode.expand_records(rec, torch.tensor(seeds[i].view(np.int32)), P)
        np.testing.assert_array_equal(coef.numpy().view(np.uint32),
                                      np.asarray(w_coef).view(np.uint32), err_msg=str(i))
        assert int(seed.numpy().view(np.uint32)) == int(w_seed)


def test_decode_block_matches_ulcx(dec_windows):
    """Four blocks of two streams, each block's window at the offset the
    one before ends at: bits, corrupt flags and the RNG state exact
    against ulcx's decode_block, PCM within 1e-5 RMS; bits, flags, PCM
    and carry identical to the port's decode_stream."""
    _, streams, win = dec_windows
    cfg, tcfg = CodecConfig(**KW), TCodecConfig(**KW)
    step = jax.jit(lambda w, c: jdec.decode_block(w, c, cfg))
    for i in range(2):
        s = torch.from_numpy(streams[i])
        pcm_s, bits_s, corrupt_s, (_, carry_s) = tdec.decode_stream(s, 4, win, tcfg, device="cpu")
        jc, tc = jdec.DecoderCarry.init(cfg), tdec.DecoderCarry.init(tcfg, 1, "cpu")
        tc = tdec.DecoderCarry(*(v[0] for v in tc))
        off = 0
        for j in range(4):
            window = streams[i, off: off + win]
            w_pcm, jc, w_bits, w_corrupt = step(jnp.asarray(window), jc)
            pcm, tc, bits, corrupt = tdec.decode_block(torch.from_numpy(window), tc, tcfg)
            assert int(bits) == int(w_bits) and bool(corrupt) == bool(w_corrupt)
            assert int(tc.rng.numpy().view(np.uint32)) == int(jc.rng)
            assert float(np.sqrt(np.mean((pcm.numpy() - np.asarray(w_pcm)) ** 2))) <= PCM_RMS
            assert torch.equal(pcm, pcm_s[j]) and int(bits) == int(bits_s[j])
            assert bool(corrupt) == bool(corrupt_s[j])
            off += (int(bits) + 7) // 8
        for g, w in zip(tc, carry_s):
            assert torch.equal(g, w)
