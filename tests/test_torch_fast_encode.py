"""The port's bitstream stages vs ulcx's on the same AnalyzedBlock.

ulcx's analysis of bench.make_corpus and tests/material.py signals
(bs256 stereo) gives the AnalyzedBlocks, as numpy. ulcx's
``prepare_fast`` of each feeds both packages' ``search_materialize_fast``
(ulcx's kernels in interpret mode): from there on the encoder is integer
logic plus exactly rounded float steps, so the chosen coefficient
count, the size and every byte must be identical.

The port's own ``prepare_fast`` is held to bounds instead: its noise and
HF-extension fits are differences of prefix sums, which ulcx forms in
float32 in XLA's summation order and the port accumulates in float64
(the same on the CPU and the card). The HF fit is ill-conditioned on
flat segment tails, so the two disagree there (ROADMAP C).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import material
from bench import make_corpus
from ulcx.analysis.batched import analyze_block_batched as j_analyze
from ulcx.bitstream import fast_encode as jfe
from ulcx.codec.encoder import init_carry_batched as j_init
from ulcx.codec.encoder import max_block_bytes
from ulcx.utils.config import CodecConfig
from ulcx_torch.analysis.block import AnalyzedBlock
from ulcx_torch.bitstream import fast_encode as tfe
from ulcx_torch.utils.config import CodecConfig as TCodecConfig

N, C, T = 256, 2, 3
KW = dict(rate_hz=44100, n_chan=C, block_size=N, use_pallas="on")
CFG, TCFG = CodecConfig(**KW), TCodecConfig(**KW)  # ulcx's, the port's
MAX_BYTES = max_block_bytes(CFG)


@pytest.fixture(scope="module")
def blocks():
    """ulcx AnalyzedBlocks (numpy leaves, [8, ...]) of T block steps."""
    real = [material.blocks_of(k, N, T, C) for k in ("speech", "percussion", "poly")]
    x = np.concatenate([make_corpus(5, T, N), np.stack(real)]).astype(np.float32)
    step = jax.jit(lambda c, blk: j_analyze(c, blk, CFG))
    carry, out = j_init(CFG, x.shape[0]), []
    for j in range(T):
        carry, blk = step(carry, jnp.asarray(x[:, j]))
        out.append(jax.tree_util.tree_map(np.asarray, blk))
    return out


def _port_block(blk):
    return AnalyzedBlock(*(torch.from_numpy(np.array(v)) for v in blk))


_SEARCH = jax.jit(lambda b, n, bud: jfe.search_materialize_fast(
    jfe.prepare_fast(b, CFG), n, bud, CFG, MAX_BYTES, True))
_PREPARE = jax.jit(lambda b: jfe.prepare_fast(b, CFG))


def _budget(blk, rate_kbps):
    return np.full(blk.n_nz.shape, int(N * rate_kbps * 1000.0 / 44100.0), np.int32)


@pytest.mark.parametrize("step", range(T))
@pytest.mark.parametrize("rate_kbps", [128.0, 48.0])
def test_search_materialize_identical(blocks, step, rate_kbps):
    blk, budget = blocks[step], _budget(blocks[step], rate_kbps)
    jb = jax.tree_util.tree_map(jnp.asarray, blk)
    wn, ws, wd = (np.asarray(v) for v in _SEARCH(jb, jb.n_nz, jnp.asarray(budget)))
    fb = tfe.FastBlockData(*(torch.from_numpy(np.array(v)) for v in _PREPARE(jb)))
    gn, gs, gd = tfe.search_materialize_fast(
        fb, torch.from_numpy(blk.n_nz), torch.from_numpy(budget), TCFG, MAX_BYTES)
    np.testing.assert_array_equal(gn.numpy(), wn)
    np.testing.assert_array_equal(gs.numpy(), ws)
    np.testing.assert_array_equal(gd.numpy(), wd)
    assert (gs.numpy() <= budget).all()


_RATE_SEARCH = jax.jit(lambda b, n, bud: jfe.rate_search_fast(
    jfe.prepare_fast(b, CFG), n, bud, CFG, True))


@pytest.mark.parametrize("step", range(T))
@pytest.mark.parametrize("rate_kbps", [128.0, 48.0])
def test_rate_search_fast_identical(monkeypatch, blocks, step, rate_kbps):
    """rate_search_fast of ulcx (interpret mode) and of the port, and the
    n_out of the port's fused search_materialize_fast, count for count;
    the port's launches p1, p2 and p3 size three times and p3
    materialize never."""
    from test_torch_rate_paths import _counting

    blk, budget = blocks[step], _budget(blocks[step], rate_kbps)
    jb = jax.tree_util.tree_map(jnp.asarray, blk)
    want = np.asarray(_RATE_SEARCH(jb, jb.n_nz, jnp.asarray(budget)))
    fb = tfe.FastBlockData(*(torch.from_numpy(np.array(v)) for v in _PREPARE(jb)))
    n_nz, bud = torch.from_numpy(np.array(blk.n_nz)), torch.from_numpy(budget)
    counts = _counting(monkeypatch)
    got = tfe.rate_search_fast(fb, n_nz, bud, TCFG)
    assert tuple(counts.values()) == (3, 3, 3, 0)
    fused, _, _ = tfe.search_materialize_fast(fb, n_nz, bud, TCFG, MAX_BYTES)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(fused.numpy(), want)


def test_cand_count():
    for b, p in ((8, 512), (13, 768), (512, 4096), (8, 32768)):
        assert tfe.cand_count(b, p) == jfe.cand_count(b, p) == 8


@pytest.mark.parametrize("step", range(T))
def test_port_prepare_within_bounds(blocks, step):
    """The port's whole bitstream stage from ulcx's AnalyzedBlock: every
    block within budget and the total size within the slice's 1 %
    end-to-end bound of ulcx's."""
    blk, budget = blocks[step], _budget(blocks[step], 128.0)
    jb = jax.tree_util.tree_map(jnp.asarray, blk)
    _, ws, _ = (np.asarray(v) for v in _SEARCH(jb, jb.n_nz, jnp.asarray(budget)))
    tb = _port_block(blk)
    _, gs, _ = tfe.search_materialize_fast(
        tfe.prepare_fast(tb, TCFG), tb.n_nz, torch.from_numpy(budget), TCFG, MAX_BYTES)
    assert (gs.numpy() <= budget).all()
    assert abs(int(gs.sum()) - int(ws.sum())) <= 0.01 * int(ws.sum())


def test_prepare_fast_matches(blocks):
    """Integer planes exact. The noise amplitude is the exp of a mean
    of a prefix-sum difference over >= 1 line: f32 cancellation in that
    difference leaves ~1e-3 relative. The HF fit is a 2x2 least-squares
    solve on such differences; its validity flag must agree on most
    lines (on flat tails its sign is noise in either package)."""
    blk = blocks[1]
    want = jax.tree_util.tree_map(np.asarray, _PREPARE(jax.tree_util.tree_map(jnp.asarray, blk)))
    got = tfe.prepare_fast(_port_block(blk), TCFG)
    for name in ("coef", "aux", "key", "window_ctrl", "header", "n_header"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name), name)
    np.testing.assert_allclose(got.amp_noise.numpy(), want.amp_noise, rtol=1e-2, atol=0)
    hf_ok_same = (got.hf_meta.numpy() >> 8) == (want.hf_meta >> 8)
    assert hf_ok_same.mean() > 0.8


def test_thresholds_and_ladder_pieces_match():
    """_qmin_ge, _final_cands and one _bracket_search on synthetic sizes
    agree with ulcx's."""
    rng = np.random.default_rng(5)
    m = np.abs(rng.standard_normal(3000) * 10.0 ** rng.uniform(-45, 5, 3000)).astype(np.float32)
    m[:4] = [0.0, 1e-45, 2.5, 1.25]
    for kind in ("2.5", "0.5", "0.125"):
        np.testing.assert_array_equal(tfe._qmin_ge(torch.from_numpy(m), kind).numpy(),
                                      np.asarray(jfe._qmin_ge(jnp.asarray(m), kind)))
    lo = rng.integers(0, 400, 16).astype(np.int32)
    hi = (lo + rng.integers(-3, 200, 16)).astype(np.int32)
    np.testing.assert_array_equal(tfe._final_cands(torch.from_numpy(lo), torch.from_numpy(hi)).numpy(),
                                  np.asarray(jfe._final_cands(jnp.asarray(lo), jnp.asarray(hi), 8)[1]))
    # a monotone size curve per stream: size(n) = slope * n + base
    slope = rng.integers(2, 9, 16).astype(np.int32)
    base = rng.integers(8, 200, 16).astype(np.int32)
    n_nz = rng.integers(300, 512, 16).astype(np.int32)
    budget = rng.integers(300, 2000, 16).astype(np.int32)

    def sizes(nn):  # numpy, jax and torch arrays alike
        return (slope[:, None] * np.asarray(nn) + base[:, None] + 7) & ~7

    wlo, whi = jfe._bracket_search(lambda nn: jnp.asarray(sizes(nn)), jnp.asarray(n_nz),
                                   jnp.asarray(budget), 8, 3)
    glo, ghi = tfe._bracket_search(lambda nn: torch.from_numpy(sizes(nn)),
                                   torch.from_numpy(n_nz), torch.from_numpy(budget), 3)
    np.testing.assert_array_equal(glo.numpy(), np.asarray(wlo))
    np.testing.assert_array_equal(ghi.numpy(), np.asarray(whi))
