"""The port on a CUDA card: each walk kernel against its plain version
(also past P = 32768), the encode and decode paths against the CPU
port, the transform backends against the dense one, the folded encode
forms against the block loop, the single-stream entry points round
trip, the pipelined decoder against the per-block one, the rate paths
(``bisect``, ``use_pallas="off"``), the gap noise window, a checkpoint
and the encode and decode tools.

Marked ``cuda``; every test skips without a card. The file imports
nothing of JAX, so on a machine without it run it past the JAX test
configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from bench import make_corpus
from chip_smoke import (
    FLAT_BLOCK_BITS, FLAT_N_NZ_SHARE, FLAT_SIZE_REL, IMDCT_TOL, PCM_RMS, all_coef_window,
    flat_n_nz_differs, imdct_gap, imdct_inputs, pack_streams, refuse_other_geometry,
    stream_seeds, synthetic_flags,
)
from ulcx_torch import _build
from ulcx_torch._build import launch_counts, reset_launch_counts
from ulcx_torch.analysis.batched import analyze_block_batched
from ulcx_torch.bitstream import decode_kernels as dk
from ulcx_torch.bitstream import encode_kernels as ek
from ulcx_torch.bitstream import fast_decode as fd
from ulcx_torch.bitstream import fast_encode as fe
from ulcx_torch.codec import transform_batched as tb
from ulcx_torch.codec.decoder import decode_stream, decode_stream_pipelined
from ulcx_torch.codec.encoder import (
    cbr_bit_budget, encode_stream, init_carry_batched, max_block_bytes,
)
from ulcx_torch.ops import dct
from ulcx_torch.parallel.mesh import batch_decode, batch_encode
from ulcx_torch.utils.config import CodecConfig
from test_torch_imdct import dct4_plane, pattern_classes

pytestmark = pytest.mark.cuda

N, C, B = 256, 2, 16
CFG = CodecConfig(rate_hz=44100, n_chan=C, block_size=N)
P = N * C
ENC, DEC = ek.Walks._fields, dk.Walks._fields  # the encode and decode walks' kernel names


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the walk kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _planes(dev, b=B, n_chan=C):
    """Walk planes of the second block of b corpus streams, with zero
    and denormal coefficients in stream 1 and a silent stream 2, plus
    candidate counts [b, 8] that include nn <= 0 and nn = P. The corpus
    is stereo: a third channel is a scaled copy of the first."""
    cfg = CodecConfig(rate_hz=44100, n_chan=n_chan, block_size=N)
    p = n_chan * N
    x = make_corpus(b, 2, N)
    if n_chan == 3:
        x = np.concatenate([x, 0.5 * x[:, :, :1]], axis=2)
    x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
    carry = init_carry_batched(cfg, b, dev)
    for j in range(2):
        carry, blk = analyze_block_batched(carry, x[:, j], cfg)
    m = blk.mdct.clone().reshape(b, -1)
    m[1, ::7] = 0.0
    m[1, 3::11] = 1e-40
    m[2] = 0.0
    blk = blk._replace(mdct=m.reshape(blk.mdct.shape))
    pl = fe.make_planes(fe.prepare_fast(blk, cfg))
    rng = np.random.default_rng(3)
    nn = rng.integers(1, p, (b, 8)).astype(np.int32)
    nn[:, 0], nn[0, 1], nn[:, 7], nn[2, 6] = 0, -3, p, p - 1
    return pl, torch.from_numpy(nn).to(dev), cfg


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.int32 and g.shape == w.shape
        assert torch.equal(g, w)


# B = 13 is not a multiple of the kernels' stream tile; P = 768 is not a
# power of two
@pytest.mark.parametrize("b,n_chan", [(B, C), (13, 2), (13, 3)])
def test_kernels_match_plain(dev, b, n_chan):
    pl, nn, cfg = _planes(dev, b, n_chan)
    t, c = fe._tc_of(pl, nn)
    reset_launch_counts()
    s12 = ek.p1(t, c, pl.key, pl.coef, pl.aux)
    _same(s12, ek.p1_plain(t, c, pl.key, pl.coef, pl.aux))
    state = ek.p2(t, c, pl.key, pl.thr, pl.aux, s12)
    _same(state, ek.p2_plain(t, c, pl.key, pl.thr, pl.aux, s12))
    _same(ek.p3_size(pl.thr, pl.aux, state), ek.p3_size_plain(pl.thr, pl.aux, state))
    for n_words in (max_block_bytes(cfg) // 4, 6):  # 6: most streams overflow it
        args = (pl.coef, pl.ampn, pl.hfamp, pl.hfmeta, pl.aux, state, pl.hdr, n_words)
        got = ek.p3_materialize(*args)
        _same(got, ek.p3_materialize_plain(*args))
    assert (got[1] < 0).any()  # packed words use the register's top bit
    torch.cuda.synchronize()
    assert launch_counts(*ENC) == {"p1": 1, "p2": 1, "p3_size": 1, "p3_materialize": 2}


def test_wrappers_refuse_mixed_devices_and_types(dev):
    pl, nn, _ = _planes(dev)
    t, c = fe._tc_of(pl, nn)
    with pytest.raises(ValueError, match="several devices"):
        ek.p1(t.cpu(), c, pl.key, pl.coef, pl.aux)
    with pytest.raises(TypeError):
        ek.p1(t, c, pl.key, pl.coef.double(), pl.aux)
    with pytest.raises(ValueError, match="contiguous"):
        ek.p3_size(pl.thr.t().contiguous().t(), pl.aux, torch.zeros(P, B, 8, dtype=torch.int32,
                                                                     device=dev))


def test_encode_path_on_card_matches_cpu(dev):
    x = torch.from_numpy(make_corpus(8, 2, N))
    reset_launch_counts()
    got, _ = batch_encode(x, CFG, "cbr", rate_kbps=128.0, device=dev)
    torch.cuda.synchronize()
    assert launch_counts(*ENC) == {"p1": 6, "p2": 6, "p3_size": 4, "p3_materialize": 2}
    want, _ = batch_encode(x, CFG, "cbr", rate_kbps=128.0, device="cpu")
    assert torch.equal(got.window_ctrl.cpu(), want.window_ctrl)
    assert int(got.size_bits.max()) <= int(cbr_bit_budget(CFG, 128.0))
    # analysis floats round differently on the card: sizes within 1 %
    g, w = int(got.size_bits.sum()), int(want.size_bits.sum())
    assert abs(g - w) <= 0.01 * w


def _streams(x, cfg):
    """The CPU port's CBR-128 encode of x [B, T, C, N], packed into
    streams as chip_smoke.py packs them: (streams, window bytes, sizes)."""
    out, _ = batch_encode(x, cfg, "cbr", rate_kbps=128.0, device="cpu")
    streams, _, win, sizes = pack_streams(out)
    return streams, win, sizes


def test_decode_kernels_match_plain(dev):
    """Both FSM modes, RNG-expand and RNG on the card against their plain
    versions, on the first and last block windows of corpus streams,
    with garbage windows and seeds that have bit 31 set."""
    streams, win, sizes = _streams(make_corpus(B, 3, N), CFG)
    off = (sizes[:, :2] // 8).sum(1)
    last = torch.gather(streams, 1, off[:, None] + torch.arange(win))
    garbage = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (4, win), dtype=np.uint8))
    windows = torch.cat([streams[:, :win], last, garbage]).to(dev)
    wc, _, tokens = fd._header_and_tokens(windows)
    reset_launch_counts()
    got = dk.fsm(wc, tokens, P, N)
    for g, w in zip(got, dk.fsm_plain(wc, tokens, P, N)):
        assert torch.equal(g, w)
    flags, consumed, corrupt = dk.fsm_place(wc, tokens, P, N)
    assert torch.equal(flags, dk.place_records(got[0], got[1], P))
    assert torch.equal(consumed, got[2]) and torch.equal(corrupt, got[3])
    assert 0 < int(corrupt.sum()) < len(corrupt)
    seed = torch.from_numpy(np.random.default_rng(5).integers(0, 2**32, flags.shape[1],
                                                             dtype=np.uint64).astype(np.uint32)
                            .view(np.int32)).to(dev)
    (coef, s1), (coef_p, s1_p) = dk.rng_expand(flags, seed), dk.rng_expand_plain(flags, seed)
    assert torch.equal(coef.view(torch.int32), coef_p.view(torch.int32)) and torch.equal(s1, s1_p)
    rflags = dk.rng_flags(flags)
    (sign, s2), (sign_p, s2_p) = dk.rng(rflags, seed), dk.rng_plain(rflags, seed)
    assert torch.equal(sign, sign_p) and torch.equal(s2, s2_p) and torch.equal(s1, s2)
    torch.cuda.synchronize()
    assert launch_counts(*DEC) == {"fsm": 1, "fsm_place": 1, "rng_expand": 1, "rng": 1}


def _fsm_windows(kind, b):
    """(windows [b, W] uint8, block size): corpus windows with
    a random second half, the same cut to 48 bytes, or all-coefficient
    windows of every pattern from 3 (bs1024: ~2,060 tokens, 17 of the
    kernel's chunks)."""
    rng = np.random.default_rng(9)
    if kind == "long":
        n = 1024
        return np.stack([all_coef_window(rng, n, C, 1100, [0x8, 3 + i % 13])
                         for i in range(b)]), n
    streams, win, _ = _streams(make_corpus(b, 2, N), CFG)
    windows = streams[:, :win].numpy().copy()
    if kind == "truncated":
        return windows[:, :48].copy(), N
    windows[:, win // 4:] = rng.integers(0, 256, (b, win - win // 4))
    windows[: b // 2] = rng.integers(0, 256, (b // 2, win))
    return windows, N


# B = 13 is not a multiple of the FSM kernel's stream tile, and 94, 2198
# and the corpus window's tokens are no multiple of its chunk
@pytest.mark.parametrize("kind", ["corrupt", "truncated", "long"])
def test_fsm_kernels_match_plain_ragged(dev, kind):
    windows, n = _fsm_windows(kind, 13)
    wc, _, tokens = fd._header_and_tokens(torch.from_numpy(windows).to(dev))
    reset_launch_counts()
    got = dk.fsm(wc, tokens, C * n, n)
    for g, w in zip(got, dk.fsm_plain(wc, tokens, C * n, n)):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    placed = dk.fsm_place(wc, tokens, C * n, n)
    for g, w in zip(placed, dk.fsm_place_plain(wc, tokens, C * n, n)):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    consumed, corrupt = got[2].cpu(), got[3].cpu()
    if kind == "truncated":
        assert (corrupt == 1).all() and (consumed == tokens.shape[0]).all()
    elif kind == "long":
        assert not corrupt.any() and (consumed > 1024).all()
    else:
        assert corrupt.any() and ((placed[0] & 1).sum(0).cpu()[corrupt == 1] > 0).any()
    torch.cuda.synchronize()
    assert launch_counts(*DEC) == {"fsm": 1, "fsm_place": 1, "rng_expand": 0, "rng": 0}


# B = 13 is not a multiple of the RNG kernels' stream tile; at P = 2048
# and 4096 stream 0's steep tail decays through the flush over a dozen
# chunks, and records cross chunk boundaries everywhere
@pytest.mark.parametrize("b,n_pos", [(13, 768), (13, 2048), (40, 4096)])
def test_rng_kernels_match_plain_on_synthetic_flags(dev, b, n_pos):
    flags = torch.from_numpy(synthetic_flags(np.random.default_rng(b + n_pos), n_pos, b)).to(dev)
    seed = stream_seeds(b, 7).to(dev)
    reset_launch_counts()
    (coef, s1), (coef_p, s1_p) = dk.rng_expand(flags, seed), dk.rng_expand_plain(flags, seed)
    assert torch.equal(coef.view(torch.int32), coef_p.view(torch.int32)) and torch.equal(s1, s1_p)
    rflags = dk.rng_flags(flags)
    (sign, s2), (sign_p, s2_p) = dk.rng(rflags, seed), dk.rng_plain(rflags, seed)
    assert torch.equal(sign, sign_p) and torch.equal(s2, s2_p) and torch.equal(s1, s2)
    tail = coef[:1500, 0].cpu()
    assert (tail[:600] != 0).all() and (tail[700:] == 0).all()
    assert (coef < 0).any() and (coef > 0).any()
    torch.cuda.synchronize()
    assert launch_counts(*DEC) == {"fsm": 0, "fsm_place": 0, "rng_expand": 1, "rng": 1}


def test_entry_points_refuse_other_geometry(dev):
    refuse_other_geometry(_build.library())


def test_decode_path_on_card_matches_cpu(dev):
    t = 3
    streams, win, sizes = _streams(make_corpus(8, t, N), CFG)
    reset_launch_counts()
    pcm, bits, corrupt = batch_decode(streams, t, win, CFG, device=dev)
    torch.cuda.synchronize()
    assert launch_counts(*DEC) == {"fsm": 0, "fsm_place": t, "rng_expand": t, "rng": 0}
    pcm_c, bits_c, corrupt_c = batch_decode(streams, t, win, CFG, device="cpu")
    assert torch.equal(bits.cpu(), bits_c) and torch.equal(corrupt.cpu(), corrupt_c)
    assert not corrupt_c.any() and torch.equal((bits_c + 7) // 8 * 8, sizes)
    # the card's float32 matrix products sum in another order
    assert float(torch.sqrt(torch.mean((pcm.cpu() - pcm_c) ** 2))) <= 1e-5


# B = 640 is every (pattern, scale, prev_last_ss) of the 16 x 8 x 5 grid;
# 13 of them in a drawn order, and one
@pytest.mark.parametrize("c", [1, 2, 3])
@pytest.mark.parametrize("n", [256, 2048, 32768])
def test_imdct_lap_kernel_matches_plain(dev, n, c):
    """The inverse transform's kernel against its plain version on the
    card (the class GEMMs, then imdct_lap_plain): PCM and lap within
    IMDCT_TOL of each row's peak (the FFT's rounding is not the GEMM's),
    last_ss exact, one launch a call. Against imdct_lap_plain of the
    numpy transcription's plane (``test_torch_imdct.dct4_plane``), the
    same float32 operations in the same order: within 1e-6 (the share
    bit-equal printed; equal wherever the kernel's sinf is torch.sin's)."""
    transform_for = CodecConfig().transform_for
    for b in (640, 13, 1):
        coefs, wc, lap, prev = args = imdct_inputs(b, c, n, dev, seed=n + 7 * b + c)
        reset_launch_counts()
        got = tb.imdct(*args, transform_for)
        torch.cuda.synchronize()
        assert launch_counts("imdct") == {"imdct": 1}
        want = tb.imdct_plain(*args, transform_for)
        assert [tuple(x.shape) for x in got] == [tuple(x.shape) for x in want]
        gap, _, last_ok = imdct_gap(got, want)
        line = f"N={n} C={c} B={b}: {gap:.2e} of the row's peak from the GEMM path"
        assert gap <= IMDCT_TOL and last_ok, line
        if b * c * n <= 1 << 22:
            x = coefs.reshape(b * c, n).cpu().numpy()
            classes = np.repeat(pattern_classes(wc.cpu().numpy(), n), c, axis=0)
            plane = torch.from_numpy(dct4_plane(x, classes)).reshape(b, c, n).to(dev)
            exact = tb.imdct_lap_plain([plane] * 4, wc, lap, prev)
            gap_t, same, last_ok = imdct_gap(got, exact)
            line += f"; {gap_t:.2e} from the transcription, {same:.6f} of the values bit-equal"
            assert gap_t <= 1e-6 and last_ok, line
        print(line)


def test_imdct_lap_refuses_mixed_devices_types_and_geometry(dev):
    coefs, wc, lap, prev = imdct_inputs(4, 2, N, dev, seed=5)
    tf = CFG.transform_for
    with pytest.raises(ValueError, match="several devices"):
        tb.imdct(coefs, wc.cpu(), lap, prev, tf)
    with pytest.raises(TypeError):
        tb.imdct(coefs, wc.long(), lap, prev, tf)
    with pytest.raises(TypeError):
        tb.imdct(coefs.double(), wc, lap, prev, tf)
    with pytest.raises(ValueError, match="contiguous"):
        tb.imdct(coefs, wc, lap.transpose(0, 1).contiguous().transpose(0, 1), prev, tf)
    with pytest.raises(ValueError, match="shape"):
        tb.imdct(coefs, wc, lap[:, :, :-1].contiguous(), prev, tf)
    with pytest.raises(ValueError, match="block size"):
        tb.imdct(coefs[..., :192].contiguous(), wc, lap[..., :96].contiguous(), prev, tf)
    # the entry point refuses a geometry other than its own, launching nothing
    lib = _build.library()
    g = tb.imdct_geometry(4, 2, N)
    tables, win, tw = tb.lap_tables(N, dev), tb.lap_windows(N, dev), tb.dct4_twiddles(N, dev)
    ptrs = (coefs, lap, wc, prev, tables, win, tw, torch.empty_like(coefs), torch.empty_like(lap),
            torch.empty_like(wc))
    good = (g["threads"], tables.numel(), win.numel(), tw.shape[0], g["shared"])
    for k, delta in ((0, -128), (1, -1), (2, -1), (3, -1), (4, -16)):
        ints = list(good)
        ints[k] += delta
        rc = lib.ulcx_imdct(*(x.data_ptr() for x in ptrs), 4, 2, N, *ints,
                            torch.cuda.current_stream().cuda_stream)
        assert rc == 1


def test_imdct_lap_on_the_decode_paths(dev):
    """One launch a block_imdct_batched call on the card: a block in
    batch_decode, two a call of decode_stream_pipelined; none with
    use_pallas="off", whose PCM is within PCM_RMS of the kernel path's
    (the plain path's GEMMs round otherwise than the kernel's FFT)."""
    t = 3
    streams, win, _ = _streams(make_corpus(8, t, N), CFG)
    reset_launch_counts()
    pcm, bits, corrupt = batch_decode(streams, t, win, CFG, device=dev)
    torch.cuda.synchronize()
    assert launch_counts("imdct") == {"imdct": t}
    reset_launch_counts()
    decode_stream_pipelined(streams[0], t, win, CFG)
    torch.cuda.synchronize()
    assert launch_counts("imdct") == {"imdct": 2}
    reset_launch_counts()
    off = dataclasses.replace(CFG, use_pallas="off")
    got = batch_decode(streams, t, win, off, device=dev)
    torch.cuda.synchronize()
    assert launch_counts("imdct") == {"imdct": 0}
    assert torch.equal(got[1], bits) and torch.equal(got[2], corrupt)
    assert float(torch.sqrt(torch.mean((got[0] - pcm) ** 2))) <= PCM_RMS


@pytest.mark.parametrize("n", [4096, 8192])
@pytest.mark.parametrize("backend", ["fact", "fft"])
def test_transform_backends_match_dense_on_card(dev, backend, n):
    gen = torch.Generator().manual_seed(n)
    xc, xs = (torch.randn(16, n, generator=gen).to(dev) for _ in range(2))
    want = dct.dct4(xc, "matmul"), dct.dst4(xs, "matmul")
    got = dct.dct4(xc, backend), dct.dst4(xs, backend)
    for g, w in zip((*got, *dct.dct4_dst4(xc, xs, backend)), (*want, *want)):
        assert g.dtype == torch.float32 and g.is_contiguous()
        assert bool(((g - w).abs() <= 1e-5 * w.abs().amax(-1, keepdim=True)).all())


@pytest.mark.parametrize("change,runs", [({"fold_bitstream": 2}, 2), ({"fold_bitstream": 4}, 1),
                                         ({"flat_stream": True}, 1)])
def test_folded_encode_on_card_matches_block_loop(dev, change, runs):
    """A ragged B = 13: the folded batches (26, 52) are no multiple of
    the walks' stream tile either, nor of 8, so every form takes the
    scan path's plan (7, 7, 6, 1) at P = 512."""
    t = 4
    x = torch.from_numpy(make_corpus(13, t, N))
    want, _ = batch_encode(x, CFG, "cbr", rate_kbps=128.0, device=dev)
    reset_launch_counts()
    got, _ = batch_encode(x, CodecConfig(rate_hz=44100, n_chan=C, block_size=N, **change), "cbr",
                          rate_kbps=128.0, device=dev)
    torch.cuda.synchronize()
    assert launch_counts(*ENC) == {"p1": 7 * runs, "p2": 7 * runs, "p3_size": 6 * runs,
                                  "p3_materialize": runs}
    assert torch.equal(got.window_ctrl, want.window_ctrl)
    if "fold_bitstream" in change:
        assert torch.equal(got.size_bits, want.size_bits) and torch.equal(got.data, want.data)
    else:
        # the card's GEMM sums the transform in another order at B*T rows
        # than at B, so near-ties fall otherwise: bounded as chip_smoke.py
        # bounds them at the flagship shape
        assert int(got.size_bits.max()) <= int(cbr_bit_budget(CFG, 128.0))
        assert int((got.size_bits - want.size_bits).abs().max()) <= FLAT_BLOCK_BITS
        g, w = int(got.size_bits.sum()), int(want.size_bits.sum())
        assert abs(g - w) <= FLAT_SIZE_REL * w, (g, w)
        assert flat_n_nz_differs(CFG, x.numpy(), dev) <= math.ceil(FLAT_N_NZ_SHARE * 13 * t)


def test_single_stream_round_trip_on_card(dev):
    """Calls of 8 and 16 blocks and the folded batch of one take the
    kernel path's plan alike (the plan follows the bitstream batch)."""
    t = 16
    x = make_corpus(4, t, N)[3]
    out, _ = encode_stream(x, CFG, "cbr", rate_kbps=128.0)
    head, carry = encode_stream(x[:8], CFG, "cbr", rate_kbps=128.0)
    tail, _ = encode_stream(x[8:], CFG, "cbr", carry=carry, rate_kbps=128.0)
    row, _ = batch_encode(x[None], dataclasses.replace(CFG, fold_bitstream=t), "cbr",
                          rate_kbps=128.0)
    for a, h, tl, r in zip(out, head, tail, row):
        assert a.device.type == "cuda"
        assert torch.equal(torch.cat([h, tl]), a) and torch.equal(r[0], a)
    streams, _, win, sizes = pack_streams(type(out)(*(v[None] for v in out)))
    reset_launch_counts()
    pcm, bits, corrupt, (off, _) = decode_stream(streams[0], t, win, CFG)
    torch.cuda.synchronize()
    assert launch_counts(*DEC) == {"fsm": 0, "fsm_place": t, "rng_expand": t, "rng": 0}
    assert not bool(corrupt.any()) and int(off) == int(sizes.sum()) // 8
    assert torch.equal(((bits + 7) // 8 * 8).cpu(), sizes[0])
    h = decode_stream(streams[0], 3, win, CFG)
    tl = decode_stream(streams[0], t - 3, win, CFG, offset=h[3][0], carry=h[3][1])
    for a, b_, w in zip(h[:3], tl[:3], (pcm, bits, corrupt)):
        assert torch.equal(torch.cat([a, b_]), w)
    pcm_c, bits_c, _, _ = decode_stream(streams[0], t, win, CFG, device="cpu")
    assert torch.equal(bits.cpu(), bits_c)
    assert float(torch.sqrt(torch.mean((pcm.cpu() - pcm_c) ** 2))) <= 1e-5


def _cpu(args):
    return tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)


def test_kernels_match_plain_past_32768(dev):
    """Stereo bs32768 (P = 65,536), a ragged B = 5: the four encode
    walks on the planes of its first block and the three decode kernels
    on the windows of its encoded bytes, each against its plain version
    run on the CPU on copies (on the card the plain versions would
    launch hundreds of thousands of small kernels)."""
    cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=32768)
    p, b = 65536, 5
    x = torch.from_numpy(make_corpus(b, 2, 32768)).to(dev)
    _, blk = analyze_block_batched(init_carry_batched(cfg, b, dev), x[:, 0], cfg)
    pl = fe.make_planes(fe.prepare_fast(blk, cfg))
    nn = torch.minimum(((blk.n_nz[:, None] + 7) // 8) * torch.arange(1, 9, device=dev),
                       blk.n_nz[:, None]).to(torch.int32)
    t, c = fe._tc_of(pl, nn)
    s12 = ek.p1(t, c, pl.key, pl.coef, pl.aux)
    _same(s12.cpu(), ek.p1_plain(*_cpu((t, c, pl.key, pl.coef, pl.aux))))
    state = ek.p2(t, c, pl.key, pl.thr, pl.aux, s12)
    _same(state.cpu(), ek.p2_plain(*_cpu((t, c, pl.key, pl.thr, pl.aux, s12))))
    ncp = state & ek.NCP_MAX
    assert bool(((ncp >= 32768) & (ncp < ek.NCP_MAX)).any())  # positions past 16 bits
    _same(ek.p3_size(pl.thr, pl.aux, state).cpu(), ek.p3_size_plain(*_cpu((pl.thr, pl.aux, state))))
    args = (pl.coef, pl.ampn, pl.hfamp, pl.hfmeta, pl.aux, state, pl.hdr, max_block_bytes(cfg) // 4)
    _same(tuple(v.cpu() for v in ek.p3_materialize(*args)), ek.p3_materialize_plain(*_cpu(args)))

    out, _ = batch_encode(x, cfg, "cbr", rate_kbps=128.0, device=dev)
    streams, _, win, _ = pack_streams(out)
    wc, _, tokens = fd._header_and_tokens(streams[:, :win].to(dev))
    got = dk.fsm(wc, tokens, p, 32768)
    for g, w in zip(got, dk.fsm_plain(*_cpu((wc, tokens)), p, 32768)):
        assert torch.equal(g.cpu(), w)
    rec = got[0].cpu()
    assert bool(((rec & dk.REC_START_MASK)[(rec >> dk.REC_START_BITS) != 0] >= 32768).any())
    flags, consumed, corrupt = dk.fsm_place(wc, tokens, p, 32768)
    for g, w in zip((flags, consumed, corrupt), dk.fsm_place_plain(*_cpu((wc, tokens)), p, 32768)):
        assert torch.equal(g.cpu(), w)
    assert not bool(corrupt.any())
    seed = stream_seeds(b, 8).to(dev)
    coef, s1 = dk.rng_expand(flags, seed)
    coef_p, s1_p = dk.rng_expand_plain(*_cpu((flags, seed)))
    assert torch.equal(coef.cpu().view(torch.int32), coef_p.view(torch.int32))
    assert torch.equal(s1.cpu(), s1_p)


def test_rate_paths_on_card(dev):
    """bisect: (ceil(log2 P) + 2, same, ceil(log2 P) + 1, 1) walks a block
    step; use_pallas="off": no kernel launched, and the kernels' bytes
    and decoded PCM."""
    t = 2
    x = torch.from_numpy(make_corpus(13, t, N))
    bcfg = CodecConfig(rate_hz=44100, n_chan=C, block_size=N, rate_search="bisect")
    reset_launch_counts()
    bis, _ = batch_encode(x, bcfg, "cbr", rate_kbps=128.0, device=dev)
    torch.cuda.synchronize()
    assert launch_counts(*ENC) == {"p1": 11 * t, "p2": 11 * t, "p3_size": 10 * t,
                                  "p3_materialize": t}
    assert int(bis.size_bits.max()) <= int(cbr_bit_budget(CFG, 128.0))
    lad, _ = batch_encode(x, CFG, "cbr", rate_kbps=128.0, device=dev)
    streams, _, win, _ = pack_streams(lad)
    dec = batch_decode(streams, t, win, CFG, device=dev)
    for cfg, ref in ((CFG, lad), (bcfg, bis)):
        off = dataclasses.replace(cfg, use_pallas="off")
        reset_launch_counts()
        got, _ = batch_encode(x, off, "cbr", rate_kbps=128.0, device=dev)
        got_dec = batch_decode(streams, t, win, off, device=dev)
        torch.cuda.synchronize()
        assert not any(launch_counts().values())
        assert torch.equal(got.data, ref.data) and torch.equal(got.size_bits, ref.size_bits)
        # bits and corrupt flags exact; PCM through the plain path's GEMMs, not the kernel's FFT
        assert torch.equal(got_dec[1], dec[1]) and torch.equal(got_dec[2], dec[2])
        assert float(torch.sqrt(torch.mean((got_dec[0] - dec[0]) ** 2))) <= PCM_RMS


def test_pipelined_decoder_on_card(dev):
    t = 8
    x = make_corpus(4, t, N)[3]
    out, _ = encode_stream(x, CFG, "cbr", rate_kbps=128.0)
    streams, _, win, _ = pack_streams(type(out)(*(v[None] for v in out)))
    pcm, bits, corrupt, (off, carry) = decode_stream(streams[0], t, win, CFG)
    reset_launch_counts()
    ppcm, pbits, pcorrupt, (poff, pcarry) = decode_stream_pipelined(streams[0], t, win, CFG)
    torch.cuda.synchronize()
    assert launch_counts(*DEC) == {"fsm": 0, "fsm_place": t, "rng_expand": 1, "rng": 0}
    assert torch.equal(pbits, bits) and torch.equal(pcorrupt, corrupt) and torch.equal(poff, off)
    assert torch.equal(pcarry.rng, carry.rng) and torch.equal(pcarry.prev_last_ss,
                                                              carry.prev_last_ss)
    ref = pcm.double()
    assert float(torch.sqrt((ppcm.double() - ref).var() / ref.var())) < 1e-5
    assert float((pcarry.lap - carry.lap).abs().max()) <= 1e-5


def test_gap_window_on_card(dev):
    """noise_run_window="gap": p1 and p2 launched, no p3 kernel (their
    gap mode runs as whole-plane ops on the card); from the same walk
    inputs count, size and bytes equal the CPU's."""
    t = 2
    gcfg = CodecConfig(rate_hz=44100, n_chan=C, block_size=N, noise_run_window="gap")
    x = torch.from_numpy(make_corpus(13, t, N))
    reset_launch_counts()
    out, _ = batch_encode(x, gcfg, "abr", rate_kbps=128.0, avg_complexity=0.5, device=dev)
    torch.cuda.synchronize()
    assert launch_counts(*ENC) == {"p1": 7 * t, "p2": 7 * t, "p3_size": 0, "p3_materialize": 0}
    _, blk = analyze_block_batched(init_carry_batched(gcfg, 13, dev), x[:, 0].to(dev), gcfg)
    fb = fe.prepare_fast(blk, gcfg)
    budget = cbr_bit_budget(gcfg, 128.0).expand(13).to(torch.int32)
    got = fe.search_materialize_scan(fb, blk.n_nz, budget.to(dev), gcfg, max_block_bytes(gcfg))
    want = fe.search_materialize_scan(type(fb)(*(v.cpu() for v in fb)), blk.n_nz.cpu(), budget,
                                      gcfg, max_block_bytes(gcfg))
    for a, b_ in zip(got, want):
        assert torch.equal(a.cpu(), b_)
    assert int(got[1].max()) <= int(budget[0])


def _one(carry):
    """A batch-of-one carry without its batch axis."""
    return type(carry)(*(_one(x) if isinstance(x, tuple) else x[0] for x in carry))


def test_checkpoint_and_tools_on_card(dev, tmp_path):
    """encode_stream resumed from a checkpoint on the card gives one
    call's bytes; the encode and decode tools run there, the decode tool
    through the pipelined decoder: its PCM16 equals that decoder's PCM
    (decoded in the tool's chunks) converted."""
    from ulcx_torch.analysis.block import EncoderCarry
    from ulcx_torch.container import UlcHeader
    from ulcx_torch.io.wavio import WavReader, WavWriter
    from ulcx_torch.tools.decode_tool import main as decode_main
    from ulcx_torch.tools.decode_tool import pcm_to_int
    from ulcx_torch.tools.encode_tool import main as encode_main
    from ulcx_torch.utils.checkpoint import load_carry, save_carry

    x = make_corpus(2, 8, N)[1]
    full, _ = encode_stream(x, CFG, "cbr", rate_kbps=128.0)
    head, carry = encode_stream(x[:4], CFG, "cbr", rate_kbps=128.0)
    save_carry(str(tmp_path / "c.npz"), carry)
    loaded = load_carry(str(tmp_path / "c.npz"), _one(EncoderCarry.init(CFG, 1, dev)))
    assert loaded.sample_prev.is_cuda
    tail, _ = encode_stream(x[4:], CFG, "cbr", carry=loaded, rate_kbps=128.0)
    assert torch.equal(torch.cat([head.data, tail.data]), full.data)

    wav, ulc, out = (str(tmp_path / f) for f in ("in.wav", "a.ulc", "out.wav"))
    w = WavWriter(wav, 44100, C, 16, 1)
    w.write_frames(x[:6].transpose(0, 2, 1).reshape(-1))
    w.close()
    assert encode_main(["e", wav, ulc, "128", f"-blocksize:{N}", "-chunk:4"]) == 0
    assert decode_main(["d", ulc, out, "-format:PCM16", "-chunk:4"]) == 0
    raw = open(ulc, "rb").read()
    hdr = UlcHeader.unpack(raw)
    win = -(-max(hdr.max_block_size, 16) // 64) * 64
    stream = np.concatenate([np.frombuffer(raw[hdr.stream_offs:], np.uint8),
                             np.zeros(win + 64, np.uint8)])
    pcms, off, dcarry = [], None, None
    for _ in range(hdr.n_blocks // 4):
        pcm, _, corrupt, (off, dcarry) = decode_stream_pipelined(stream, 4, win, CFG, offset=off,
                                                                 carry=dcarry)
        assert not bool(corrupt.any())
        pcms.append(pcm)
    r = WavReader(out)
    got = r.read_frames_int(r.info.n_samples)
    r.close()
    want = pcm_to_int(torch.cat(pcms), 16).transpose(1, 2).reshape(-1).cpu().numpy()
    np.testing.assert_array_equal(got, want)
