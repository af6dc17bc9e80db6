"""The port's batched analysis vs ulcx's, block by block.

Four blocks of bench.make_corpus streams and tests/material.py speech,
percussion and polyphonic signals (bs256 stereo) go through both
``analyze_block_batched`` chains from the same initial carry. Decisions
(window control, coded-coefficient counts) must be identical; floats
are held to bounds set by float32 summation order, stated per check.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import material
from bench import make_corpus
from ulcx.analysis.batched import analyze_block_batched as j_analyze
from ulcx.codec.encoder import init_carry_batched as j_init
from ulcx.utils.config import CodecConfig
from ulcx_torch.analysis.batched import analyze_block_batched as t_analyze
from ulcx_torch.analysis.block import carry_from_numpy, carry_to_numpy
from ulcx_torch.codec.encoder import init_carry_batched as t_init
from ulcx_torch.utils.config import CodecConfig as TCodecConfig

N, C, T = 256, 2, 4
KW = dict(rate_hz=44100, n_chan=C, block_size=N)
CFG, TCFG = CodecConfig(**KW), TCodecConfig(**KW)  # ulcx's, the port's


def _signals():
    """[8, T, 2, N]: five bench streams, then speech, percussion, poly."""
    real = [material.blocks_of(k, N, T, C) for k in ("speech", "percussion", "poly")]
    return np.concatenate([make_corpus(5, T, N), np.stack(real)]).astype(np.float32)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / (np.abs(want).max() + 1e-30)


@pytest.fixture(scope="module")
def runs():
    x = _signals()
    b = x.shape[0]
    step = jax.jit(lambda c, blk: j_analyze(c, blk, CFG))
    jc, tc = j_init(CFG, b), t_init(TCFG, b, "cpu")
    out = []
    for j in range(T):
        jc, jb = step(jc, jnp.asarray(x[:, j]))
        tc, tb = t_analyze(tc, torch.from_numpy(x[:, j]), TCFG)
        out.append((jax.tree_util.tree_map(np.asarray, jb), tb))
    return out, jax.tree_util.tree_map(np.asarray, jc), tc


@pytest.mark.parametrize("blk", range(T))
def test_decisions_exact(runs, blk):
    jb, tb = runs[0][blk]
    np.testing.assert_array_equal(tb.window_ctrl.numpy(), jb.window_ctrl)
    np.testing.assert_array_equal(tb.n_nz.numpy(), jb.n_nz)


def test_window_patterns_vary(runs):
    """The signals drive window switching: the comparison covers more
    than the long-window pattern."""
    wcs = np.concatenate([jb.window_ctrl for jb, _ in runs[0]])
    assert len(set((wcs >> 4).tolist())) >= 2, wcs


@pytest.mark.parametrize("blk", range(T))
def test_floats_within_tolerance(runs, blk):
    jb, tb = runs[0][blk]
    # transform: an f32 matmul of length <= N per coefficient; XLA and
    # torch sum in another order, ~1e-7 relative per term
    assert _rel(tb.mdct, jb.mdct) < 1e-5
    # noise pairs: band sums of squared coefficients, then log and exp
    # of them; the transform's rounding passes through both
    assert np.abs(tb.noise.numpy() - jb.noise).max() <= 1e-4 * (np.abs(jb.noise).max() + 1)
    # block complexity is a ratio of whole-block sums
    np.testing.assert_allclose(tb.complexity.numpy(), jb.complexity, rtol=0, atol=1e-5)
    # importance: -inf exactly where the coefficient is below the coding
    # floor (a decision, so exact). Elsewhere it is 2 ln|coef| plus the
    # masking curve, so the transform's absolute rounding (~1e-6 of the
    # block maximum) moves it by ~1e-6 * max / |coef| nepers: bounded
    # where |coef| >= 1e-4 of the maximum, and for the rest only the
    # keep order is checked, which near-ties of tiny coefficients flip
    ti, ji = tb.importance.numpy(), jb.importance
    np.testing.assert_array_equal(np.isneginf(ti), np.isneginf(ji))
    mag = np.abs(jb.mdct) / np.abs(jb.mdct).max(axis=(1, 2), keepdims=True)
    big = np.isfinite(ji) & (mag >= 1e-4)
    assert np.abs(ti[big] - ji[big]).max() < 1e-3
    b = ji.shape[0]
    rank_j = np.argsort(np.argsort(-ji.reshape(b, -1), axis=-1, kind="stable"), axis=-1)
    rank_t = np.argsort(np.argsort(-ti.reshape(b, -1), axis=-1, kind="stable"), axis=-1)
    assert (rank_j != rank_t).mean() < 0.02


def test_carry_matches_and_round_trips(runs):
    _, jc, tc = runs
    back = carry_to_numpy(tc)
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jc)):
        assert got.dtype == want.dtype and got.shape == want.shape
        # filter state: EMA matmuls in another summation order
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    again = carry_from_numpy(jc, "cpu")
    for got, want in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(jc)):
        np.testing.assert_array_equal(got.numpy(), want)
