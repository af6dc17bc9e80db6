"""The inputs the benchmark makes from ``--seed``: the corpus and the
decode traffic's bitstreams."""

from __future__ import annotations

import numpy as np
import torch

from benchmarks import bitgen, spec
from benchmarks.corpus import make_corpus
from benchmarks.reference import syntax

MIX = spec.traffic("decode_b8192")["mix"]
SEED = 2**31 + 3  # more than 32 signed bits hold


def _corpus(seed):
    return make_corpus(torch.Generator().manual_seed(seed), 6, 2, 2, 256, 44100, "cpu")


def test_corpus_follows_the_seed():
    a, b, c = _corpus(SEED), _corpus(SEED), _corpus(SEED + 1)
    assert a.shape == (6, 2, 2, 256) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.abs().max() <= 1.0 and a.std() > 0.01


def _blocks(seed, rows=64):
    return bitgen.generate_blocks(np.random.default_rng(seed), rows, 2048, 2, 5944, MIX)


def test_bitstreams_follow_the_seed():
    a, b, c = _blocks(SEED), _blocks(SEED), _blocks(SEED + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])


def test_every_generated_block_decodes_clean_and_fills_the_budget():
    rows, t = 64, 4
    nyb, count, wc = _blocks(SEED, rows)
    streams, bits, window = bitgen.pack_streams(nyb, count, rows // t, t)
    assert window == 832 and bits.max() <= 5944 and bits.min() >= 5944 - 20
    seen = set()
    for s in range(rows // t):
        data = syntax.nybbles_of(streams[s])
        pos, rng = 0, syntax.SEED
        for k in range(t):
            blk = syntax.parse_block(data, pos, 2048, 2)
            assert not blk.corrupt and 4 * blk.nybbles == bits[s, k] and blk.wc == wc[s * t + k]
            _, rng = syntax.coefficients(blk, 2048, 2, rng)
            seen.add(blk.wc >> 4)
            pos += 2 * ((blk.nybbles + 1) // 2)
    assert seen == set(range(1, 16))  # every window-switch pattern


def test_generated_mix_follows_the_frozen_one():
    nyb, count, _ = _blocks(SEED, 128)
    got = {k: 0 for k in syntax.KIND_NAMES}
    for r in range(128):
        for rec in syntax.parse_block([int(v) for v in nyb[r, : count[r]]], 0, 2048, 2).records:
            got[syntax.KIND_NAMES[rec[0]]] += 1
    kinds = ("coef", "zeros", "noise", "zeros_long")
    for k in kinds[:3]:
        want = MIX["records"][k] / sum(MIX["records"].get(x, 0) for x in kinds)
        share = got[k] / sum(got[x] for x in kinds)
        assert abs(share - want) < 0.05, (k, share, want)
