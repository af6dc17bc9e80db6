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
tests share) and seeds that have bit 31 set.

The module also builds the windows that tests/test_torch_decode.py uses.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_fuzz_decoder
from chip_smoke import synthetic_flags
from ulcx.bitstream import fast_decode as jfd
from ulcx.bitstream import pallas_decode as pd
from ulcx.codec.encoder import encode_stream_batched
from ulcx.utils.config import CodecConfig
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
    """A window whose every segment is coded coefficient by coefficient:
    a quantizer nybble, then one coefficient nybble per position. It
    ends after n_chan * (segments + n) tokens."""
    from ulcx_torch.ops.patterns import pattern_subblock_sizes

    pat = wc_nybbles[1] if len(wc_nybbles) == 2 else 1
    ny = list(wc_nybbles)
    for _ in range(C):
        for ss in pattern_subblock_sizes(pat, n):
            ny.append(int(rng.integers(0, 14)))
            ny.extend(rng.choice([2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14], ss).tolist())
    ny = np.array(ny + [0] * (2 * w - len(ny)), np.uint8)
    return ny[0::2] | (ny[1::2] << 4)


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


@pytest.mark.parametrize("kind", ["real", "fuzz", "truncated", "long"])
def test_fsm_matches_ulcx(enc, kind):
    n = N
    if kind == "real":
        _, streams, offs, _ = enc
        windows = block_windows(streams, offs, W)
    elif kind == "fuzz":
        windows = fuzz_windows()
    elif kind == "truncated":
        # 48 bytes hold ~94 tokens, fewer than any block needs
        _, streams, offs, _ = enc
        windows = block_windows(streams, offs[:, :1], 48)
    else:
        # bs1024: 2050 tokens of coefficients, past the TPU's 1024-token
        # chunk, plus one garbage window
        n, rng = 1024, np.random.default_rng(7)
        windows = np.stack([
            all_coef_window(rng, n, 1100, [0x0]),
            all_coef_window(rng, n, 1100, [0x8, 0x3]),
            rng.integers(0, 256, 1100).astype(np.uint8),
        ])
    want, got = ulcx_fsm(windows, n)
    for name, w, g in zip(("rec", "code", "consumed", "corrupt"), want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy().T if g.dim() == 2 else g.numpy(), w,
                                      err_msg=name)
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
    """Every P = n_chan * block_size the decoder serves."""
    return sorted({c * (256 << s) for s in range(8) for c in range(1, 256)
                   if c * (256 << s) <= dk.MAX_P})


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
