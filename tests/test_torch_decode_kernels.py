"""The port's plain decode kernels vs ulcx's Pallas kernels (interpret mode).

Both sides read the same inputs and every output must match bit for
bit: the FSM is an integer state machine, and the expansion's floats
are exact products except the tail decay, one rounded product per step
in the same order on both sides (the port flushes a magnitude that
leaves the normal range, as XLA does). Inputs: windows of ulcx-encoded
bs256 stereo streams (P = 512), the garbage and mutated windows of
tests/test_fuzz_decoder.py, a truncated window, a bs1024 window longer
than the TPU's 1024-token chunk, and synthetic record flags at P = 2048
with long tail runs (``chip_smoke.synthetic_flags``, which the card
tests share) and seeds that have bit 31 set. The FSM kernel's packed
syntax table is unpacked against the plain version's tables and stepped
in numpy as the kernel steps it.

The module also builds the windows that tests/test_torch_decode.py uses.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_fuzz_decoder
from chip_smoke import all_coef_window as _all_coef_window
from chip_smoke import synthetic_flags
from ulcx.bitstream import fast_decode as jfd
from ulcx.bitstream import pallas_decode as pd
from ulcx.codec.encoder import encode_stream_batched
from ulcx.utils.config import CodecConfig
from ulcx_torch._build import launch_counts, reset_launch_counts
from ulcx_torch.bitstream import decode_kernels as dk
from ulcx_torch.bitstream import encode_kernels as ek
from ulcx_torch.bitstream.fast_decode import _header_and_tokens

N, C = 256, 2
P = N * C
B_ENC, T_ENC = 8, 4
W = test_fuzz_decoder.W  # 160 bytes, more than a 160 kbps block at bs256
CFG = CodecConfig(rate_hz=44100, n_chan=C, block_size=N, use_pallas="on")
LANES = pd.LANES


def encoded_streams():
    """ulcx CBR-160 encodes of the fuzz test's content (same call, same
    shapes): (x [8, 4, C, N], streams [8, S] uint8, block offsets [8, 4],
    size_bits [8, 4])."""
    rng = np.random.default_rng(0xC0DEC)
    x = rng.standard_normal((B_ENC, T_ENC, C, N)).astype(np.float32) * 0.3
    x[:, 2, :, 40] += 1.0
    out, _ = jax.jit(
        lambda b: encode_stream_batched(b, test_fuzz_decoder.CFG, "cbr", rate_kbps=160.0)
    )(jnp.asarray(x))
    sizes, data = np.asarray(out.size_bits), np.asarray(out.data)
    return (x,) + pack_streams(sizes, data, 1024) + (sizes,)


def pack_streams(sizes, data, win):
    """Concatenate each stream's blocks: (streams [B, T*win + win + 64],
    block byte offsets [B, T])."""
    b, t = sizes.shape
    streams = np.zeros((b, t * win + win + 64), np.uint8)
    offs = np.zeros((b, t), np.int64)
    for i in range(b):
        off = 0
        for j in range(t):
            nb = int(sizes[i, j]) // 8
            offs[i, j] = off
            streams[i, off : off + nb] = data[i, j, :nb]
            off += nb
    return streams, offs


def block_windows(streams, offs, w):
    """Every block's window of w bytes: [B*T, w], stream-major."""
    return np.stack([streams[i, o : o + w] for i in range(offs.shape[0]) for o in offs[i]])


def fuzz_windows():
    """256 of the fuzz test's 1024 windows: one garbage window per
    (pattern, scale), all 16 patterns, and every fourth mutated one."""
    return test_fuzz_decoder._make_windows(np.random.default_rng(0xC0DEC))[::4]


def all_coef_window(rng, n, w, wc_nybbles):
    """A window whose every segment is coded coefficient by coefficient
    (``chip_smoke.all_coef_window``, which the card run shares), at this
    module's channel count."""
    return _all_coef_window(rng, n, C, w, wc_nybbles)


def _lanes(x):
    """[B, ...] -> [G, ..., 128] with the batch padded to the lanes."""
    b = x.shape[0]
    g = -(-b // LANES)
    xp = np.concatenate([x, np.zeros((g * LANES - b,) + x.shape[1:], x.dtype)])
    return np.moveaxis(xp.reshape((g, LANES) + x.shape[1:]), 1, -1), g


def _from_lanes(y, b):
    return np.moveaxis(y, -1, 1).reshape((-1,) + y.shape[1:-1])[:b]


def ulcx_fsm(windows, n):
    """ulcx's FSM kernel on the windows -> (rec, code [B, T], consumed,
    corrupt [B]) and the port's plain FSM on the same tokens."""
    b = windows.shape[0]
    wc, _, tokens = _header_and_tokens(torch.from_numpy(windows))
    wc_np = wc.numpy()
    wc_l = np.concatenate([wc_np, np.full((-b) % LANES, 0x10, np.int32)]).reshape(-1, LANES)
    tok_l, _ = _lanes(tokens.numpy().T.copy())
    rec, code, consumed, corrupt = pd.fsm_kernel_call(
        jnp.asarray(wc_l), jnp.asarray(tok_l), C * n, n, interpret=True)
    want = (_from_lanes(np.asarray(rec), b), _from_lanes(np.asarray(code), b),
            np.asarray(consumed).reshape(-1)[:b], np.asarray(corrupt).reshape(-1)[:b])
    got = dk.fsm_plain(wc, tokens, C * n, n)
    return want, got


@pytest.fixture(scope="module")
def enc():
    return encoded_streams()


def test_next_end_table_matches():
    for n in (256, 2048):
        np.testing.assert_array_equal(dk._next_end_table(n), pd._next_end_table(n))


KINDS = ["real", "fuzz", "truncated", "long"]


def _windows(enc, kind):
    """(windows [B, W] uint8, block size) of one kind."""
    if kind == "real":
        _, streams, offs, _ = enc
        return block_windows(streams, offs, W), N
    if kind == "fuzz":
        return fuzz_windows(), N
    if kind == "truncated":
        # 48 bytes hold ~94 tokens, fewer than any block needs
        _, streams, offs, _ = enc
        return block_windows(streams, offs[:, :1], 48), N
    # bs1024: 2050 tokens of coefficients, past the TPU's 1024-token
    # chunk, plus one garbage window
    n, rng = 1024, np.random.default_rng(7)
    return np.stack([
        all_coef_window(rng, n, 1100, [0x0]),
        all_coef_window(rng, n, 1100, [0x8, 0x3]),
        rng.integers(0, 256, 1100).astype(np.uint8),
    ]), n


@pytest.mark.parametrize("kind", KINDS)
def test_fsm_matches_ulcx(enc, kind):
    """Records by field (ulcx's word holds the start in 15 bits, the
    port's in 23), everything else word for word."""
    windows, n = _windows(enc, kind)
    want, got = ulcx_fsm(windows, n)
    for name, w, g in zip(("rec", "code", "consumed", "corrupt"), want, got):
        assert g.dtype == torch.int32
        g = g.numpy().T if g.dim() == 2 else g.numpy()
        if name == "rec":
            np.testing.assert_array_equal(g & dk.REC_START_MASK, w & 0x7FFF, err_msg="start")
            np.testing.assert_array_equal(g >> dk.REC_START_BITS, w >> 15, err_msg="type")
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    corrupt = want[3]
    if kind == "real":
        assert not corrupt.any()
    elif kind == "truncated":
        assert corrupt.all()  # exhausted, not a syntax error: every token read
        assert (want[2] == 2 * 48 - 2).all()
    elif kind == "long":
        assert list(corrupt[:2]) == [0, 0] and (want[2][:2] > 1024).all()
    else:
        assert 0 < corrupt.sum() < len(corrupt)


@pytest.mark.parametrize("kind", KINDS)
def test_fsm_place_matches_ulcx(enc, kind):
    """The placing mode's plain version against ulcx's two steps: its FSM
    kernel, then its record placement."""
    windows, n = _windows(enc, kind)
    (rec, code, consumed, corrupt), _ = ulcx_fsm(windows, n)
    want = np.asarray(jfd.records_to_flags(jnp.asarray(rec), jnp.asarray(code), C * n))
    wc, _, tokens = _header_and_tokens(torch.from_numpy(windows))
    flags, g_consumed, g_corrupt = dk.fsm_place_plain(wc, tokens, C * n, n)
    assert flags.dtype == torch.int32 and tuple(flags.shape) == (C * n, windows.shape[0])
    np.testing.assert_array_equal(flags.numpy().T, want)
    np.testing.assert_array_equal(g_consumed.numpy(), consumed)
    np.testing.assert_array_equal(g_corrupt.numpy(), corrupt)
    assert (want & 1).any()
    # the wrapper takes the plain version on CPU tensors and counts no launch
    reset_launch_counts()
    for g, w in zip(dk.fsm_place(wc, tokens, C * n, n), (flags, g_consumed, g_corrupt)):
        assert torch.equal(g, w)
    assert launch_counts("fsm_place") == {"fsm_place": 0}


def _unpack(words, name):
    shift, bits = dk.SYNTAX_FIELDS[name]
    field = (words.astype(np.int64) >> shift) & ((1 << bits) - 1)
    return field - 1 if name == "qi" else field


def test_syntax_words_unpack_to_tables():
    """Every field of the kernel's packed (mode, nybble) word is the plain
    version's table entry, and the fields tile bits 0-30 without overlap."""
    words, tab = dk._syntax_words(), dk._syntax_tables()
    assert words.dtype == np.int32 and words.shape == (256,) and (words >= 0).all()
    assert set(dk.SYNTAX_FIELDS) == set(tab)
    for name in tab:
        np.testing.assert_array_equal(_unpack(words, name), tab[name], err_msg=name)
    used = sorted(dk.SYNTAX_FIELDS.values())
    assert used[0][0] == 0 and all(s0 + n0 <= s1 for (s0, n0), (s1, _) in zip(used, used[1:]))
    assert sum(used[-1]) == 31
    # a bad quantizer token goes straight to CORRUPT; ended modes stay
    assert _unpack(words, "next")[dk.M_QUANT_START * 16 + 0xF] == dk.M_CORRUPT
    for m in (dk.M_DONE, dk.M_CORRUPT):
        assert (words[m * 16:m * 16 + 16] == m).all()
    # the three run forms and the level, by hand
    i = dk.M_LRUN_X * 16 + 5
    assert (_unpack(words, "n0")[i], _unpack(words, "nmul")[i]) == (38, 16)
    i = dk.M_NOISE_X * 16 + 7
    assert [_unpack(words, f)[i] for f in ("n0", "nmul", "a0")] == [17, 2, 4]
    assert _unpack(words, "n0")[dk.M_ZSHORT * 16 + 9] == 10
    assert _unpack(words, "qi")[dk.M_QUANT_EXT_S * 16 + 3] == 0xE + 3


def _step_words(wc, tokens, p_tot, n):
    """The FSM kernel's walk in numpy, from the packed words alone: one
    table read a token, selects on its fields, the segment end carried
    and looked up again only when a record ends its segment; the walker
    leaves the record word and its registers, from which the code and
    expansion words are built afterwards, as the kernel's helpers do.
    Returns (rec, code [T, B], flags [P, B], consumed, corrupt)."""
    words = dk._syntax_words().astype(np.int64)
    t_len, b = tokens.shape
    seg = dk._next_end_table(n)[(wc >> 4) & 15].astype(np.int64)  # [B, 8]
    shift = int(np.log2(n // 8))
    lane = np.arange(b)
    mode, pos, qi, r0, cnt = (np.zeros(b, np.int64) for _ in range(5))
    se = seg[:, 0].copy()
    rec, code = np.zeros((t_len, b), np.int64), np.zeros((t_len, b), np.int64)
    flags = np.zeros((p_tot, b), np.int64)
    for t in range(t_len):
        x = tokens[t].astype(np.int64) & 15
        w = words[mode * 16 + x]
        cnt += mode < dk.M_DONE
        kind = (w >> 4) & 7
        n_run = ((w >> 16) & 63) + r0 * ((w >> 22) & 31)
        end = np.where(((w >> 15) & 1) == 1, pos + n_run,
                       np.where(kind == dk.REC_COEF, pos + 1, se))
        run_bad = end > se
        emit = (kind != 0) & ~run_bad
        rec[t] = np.where(emit, pos | (kind << dk.REC_START_BITS), 0)
        regs = (w & (0xF << 27)) | (x << 16) | (qi << 8) | r0
        # the helpers' part: code and expansion words from the staged pair
        kind_h, r0_h, x_h = rec[t] >> dk.REC_START_BITS, regs & 0xFF, (regs >> 16) & 15
        tail = kind_h == dk.REC_TAIL
        a = ((regs >> 27) & 15) + np.where(tail, r0_h >> 4, 0)
        dn = np.where(tail, ((r0_h & 0xF) << 4) | x_h, 0)
        code[t] = np.where(kind_h != 0, a | (dn << 5) | (((regs >> 8) & 31) << 13), 0)
        flags[(rec[t] & dk.REC_START_MASK)[emit], lane[emit]] = (
            ((0xB3150 >> (kind_h * 4)) & 0xF) | (code[t] << 4))[emit]
        nxt = np.where(kind != 0, np.where(end >= p_tot, dk.M_DONE,
                                           np.where(end == se, dk.M_QUANT_START, dk.M_NORMAL)),
                       w & 15)
        nxt = np.where(run_bad, dk.M_CORRUPT, nxt)
        load = (w >> 13) & 3
        r0 = np.where(load == 1, x, np.where(load == 2, ((r0 << 4) | x) & 0xFF, r0))
        q = (w >> 8) & 31
        qi = np.where(q != 0, q - 1, qi)
        pos = np.where(emit, end, pos)
        fresh = (pos & ~(n - 1)) + seg[lane, (pos & (n - 1)) >> shift]
        se = np.where(emit & (end == se), fresh, se)
        mode = nxt
    return rec, code, flags, cnt, (mode != dk.M_DONE).astype(np.int64)


@pytest.mark.parametrize("kind", ["fuzz", "long"])
def test_stepping_the_syntax_words_reproduces_fsm_plain(enc, kind):
    windows, n = _windows(enc, kind)
    wc, _, tokens = _header_and_tokens(torch.from_numpy(windows))
    want = dk.fsm_plain(wc, tokens, C * n, n)
    want_flags = dk.place_records(want[0], want[1], C * n)
    rec, code, flags, consumed, corrupt = _step_words(wc.numpy(), tokens.numpy(), C * n, n)
    for name, w, g in zip(("rec", "code", "consumed", "corrupt", "flags"),
                          (*want, want_flags), (rec, code, consumed, corrupt, flags)):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    assert corrupt.any() and not corrupt.all()


def _seeds(rng, b):
    s = rng.integers(0, 2**32, b, dtype=np.uint64).astype(np.uint32)
    s[1::2] |= np.uint32(1 << 31)
    s[0] = dk.SEED
    return s


def _expand_both(flags, seeds):
    b = flags.shape[1]
    fl_l, _ = _lanes(flags.T.copy())
    sd_l = np.concatenate([seeds, np.full((-b) % LANES, dk.SEED, np.uint32)]).reshape(-1, LANES)
    coef, seed = pd.rng_expand_kernel_call(jnp.asarray(fl_l), jnp.asarray(sd_l), flags.shape[0],
                                           interpret=True)
    want = (_from_lanes(np.asarray(coef), b).T, np.asarray(seed).reshape(-1)[:b])
    got = dk.rng_expand_plain(torch.from_numpy(flags), torch.from_numpy(seeds.view(np.int32)))
    return want, got


@pytest.mark.parametrize("kind", ["real", "synthetic"])
def test_rng_expand_matches_ulcx(enc, kind):
    rng = np.random.default_rng(11)
    if kind == "real":
        _, streams, offs, _ = enc
        windows = jnp.asarray(block_windows(streams, offs, W))
        rec, code, *_ = jfd.fsm_records(windows, CFG, interpret=True)
        flags = np.asarray(jfd.records_to_flags(rec, code, P)).T.copy()
    else:
        flags = synthetic_flags(rng, 2048, 6)  # P = 2048: two of the TPU's chunks
    seeds = _seeds(rng, flags.shape[1])
    (w_coef, w_seed), (g_coef, g_seed) = _expand_both(flags, seeds)
    # as bits: signed zeros and the flushed tail included
    np.testing.assert_array_equal(g_coef.numpy().view(np.uint32), w_coef.view(np.uint32))
    np.testing.assert_array_equal(g_seed.numpy().view(np.uint32), w_seed)
    assert (w_coef != 0).any() and (w_coef < 0).any()
    if kind == "synthetic":
        tail = w_coef[:1500, 0]
        assert (tail[:600] != 0).all() and (tail[700:] == 0).all()


def test_rng_matches_ulcx(enc):
    """The unfused sign replay, on the flags the helper derives from real
    expansion flags."""
    rng = np.random.default_rng(12)
    flags = synthetic_flags(rng, P, 4)
    _, streams, offs, _ = enc
    rec, code, *_ = jfd.fsm_records(jnp.asarray(block_windows(streams, offs[:, :2], W)), CFG,
                                    interpret=True)
    flags = np.concatenate([flags, np.asarray(jfd.records_to_flags(rec, code, P)).T], axis=1)
    b = flags.shape[1]
    rflags = dk.rng_flags(torch.from_numpy(flags.copy()))
    seeds = _seeds(rng, b)
    fl = np.concatenate([rflags.numpy(), np.zeros((P, LANES - b), np.int32)], axis=1)
    sd = np.concatenate([seeds, np.full(LANES - b, dk.SEED, np.uint32)])
    sign, seed = pd.rng_kernel_call(jnp.asarray(fl), jnp.asarray(sd), P, interpret=True)
    g_sign, g_seed = dk.rng_plain(rflags, torch.from_numpy(seeds.view(np.int32)))
    np.testing.assert_array_equal(g_sign.numpy(), np.asarray(sign)[:, :b])
    np.testing.assert_array_equal(g_seed.numpy().view(np.uint32), np.asarray(seed)[:b])
    # the signs are the fused kernel's: coef = sign * |coef| on draw positions
    coef, _ = dk.rng_expand_plain(torch.from_numpy(flags.copy()), torch.from_numpy(seeds.view(np.int32)))
    draw = (rflags.numpy() & 1) == 1
    nz = draw & (coef.numpy() != 0)
    assert nz.any()
    np.testing.assert_array_equal(np.sign(coef.numpy()[nz]), g_sign.numpy()[nz])


def _served_positions():
    """Every P = n_chan * block_size <= 32768, and P past it up to the
    top of the envelope, 255 channels x 32768 (the decoder serves every
    P)."""
    small = {c * (256 << s) for s in range(8) for c in range(1, 256) if c * (256 << s) <= 32768}
    return sorted(small | {2 * 32768, 3 * 32768, 40 * 4096, 255 * 32768})


@pytest.mark.parametrize("b", [1, 13, 128, 512, 2048])
def test_rng_geometry_covers_once(b):
    """The RNG kernels' launch geometry, at the default and at every
    stream count the sweep tries: shared memory within Hopper's
    per-block limit, the stream tiles cover every stream once, and the
    position chunks cover every P the decoder serves once, in order."""
    for streams in sorted({dk.RNG_STREAMS, 4, 8, 16, 32}):
        seen = np.zeros(b, np.int64)
        for b0, ns in dk.rng_tiles(b, streams):
            assert 1 <= ns <= streams and b0 % streams == 0
            seen[b0:b0 + ns] += 1
        assert (seen == 1).all()
        for n_pos in _served_positions():
            for expand in (True, False):
                g = dk.rng_geometry(n_pos, b, expand, streams)
                assert g["smem"] <= ek.SMEM_LIMIT, (streams, expand, g["smem"])
                assert g["grid"] == len(dk.rng_tiles(b, streams)) and g["threads"] % 32 == 0
            pos = np.zeros(n_pos, np.int64)
            chunks = ek.walk_chunks(n_pos, g["chunk"], False)
            for lo, hi in chunks:
                assert 0 < hi - lo <= g["chunk"]
                pos[lo:hi] += 1
            assert (pos == 1).all() and chunks == sorted(chunks)


def test_rng_smem_matches_layout():
    """The byte counts the RNG entry points check, by hand at 128
    positions x 16 streams x 4 bytes per array, two stages: flags,
    pre-pass word and output, plus level and decay when expanding."""
    assert dk.rng_smem_bytes(True, 128, 16) == 2 * 5 * 128 * 16 * 4
    assert dk.rng_smem_bytes(False, 128, 16) == 2 * 3 * 128 * 16 * 4
    assert dk.rng_smem_bytes(False, 3, 13) == 2 * 3 * 160  # 39 words round up to 160 bytes
    with pytest.raises(ValueError):
        dk.rng_geometry(4096, 512, streams=33)


@pytest.mark.parametrize("b", [1, 13, 128, 512, 2048])
@pytest.mark.parametrize("t_len", [94, 1662, 2198])
def test_fsm_geometry_covers_once(b, t_len):
    """The FSM kernel's launch geometry (one for both modes), at the default and
    at every stream count the sweep tries: shared memory within Hopper's
    per-block limit, and every (token chunk, stream) served once, the
    chunks in order; 94 and 2198 tokens are no multiple of the chunk."""
    for streams in sorted({dk.FSM_STREAMS, 4, 8, 16, 32}):
        for helper_warps in (1, 3, 7):
            g = dk.fsm_geometry(t_len, b, streams, helper_warps)
            assert g["smem"] <= ek.SMEM_LIMIT and g["stages"] == 2
            assert g["threads"] == 32 * (1 + helper_warps)
            assert g["smem"] == dk.fsm_smem_bytes(g["chunk"], streams)
            tiles = dk.rng_tiles(b, g["streams"])
            chunks = ek.walk_chunks(t_len, g["chunk"], False)
            assert g["grid"] == len(tiles) and chunks == sorted(chunks)
            seen = np.zeros((t_len, b), np.int64)
            for b0, ns in tiles:
                assert 1 <= ns <= streams and b0 % streams == 0
                for lo, hi in chunks:
                    assert 0 < hi - lo <= g["chunk"]
                    seen[lo:hi, b0:b0 + ns] += 1
            assert (seen == 1).all()


def test_fsm_smem_matches_layout():
    """The byte count the FSM entry points check, by hand: 256 syntax
    words and 128 next ends, then two stages of 128 tokens x 8 streams x
    4 bytes for the token, the record word and the walker's registers."""
    assert dk.fsm_smem_bytes(128, 8) == 1024 + 512 + 2 * 3 * 128 * 8 * 4
    assert dk.fsm_smem_bytes(3, 13) == 1536 + 2 * 3 * 160  # 39 words round up to 160 bytes
    assert dk.fsm_geometry(1662, 512)["smem"] == dk.fsm_smem_bytes(dk.FSM_CHUNK, dk.FSM_STREAMS)
    assert dk._fsm_geometry_ints(1662, 512) == (8, 128, 128, dk.fsm_smem_bytes(128, 8))
    for bad in (0, 33):
        with pytest.raises(ValueError):
            dk.fsm_geometry(1662, 512, streams=bad)
    with pytest.raises(ValueError):
        dk.fsm_geometry(1662, 0)
