"""Measure the record mix of the port's CBR output on the corpus.

    python -m benchmarks.mix [STREAMS [BLOCKS [SEED]]]

Encodes STREAMS x BLOCKS blocks of the corpus (``corpus.py``) with the
port (``ulcx_torch``, on the CPU: its bytes are the card's up to float
near-ties) at the flagship's settings, CBR 128 kbps, stereo 44.1 kHz,
2048-sample blocks, reads every block with the reference syntax and
prints the ``mix`` object that ``bitgen.generate_blocks`` draws from:
the share of transient blocks, their patterns and overlap scales, the
record counts (a quantizer record counted only where it changes the
subblock's quantizer), the mean run lengths, the coefficient magnitudes,
the quantizers, and how subblocks end. The decode traffic files hold its
output, frozen; this script is not run by the benchmark.
"""

from __future__ import annotations

import collections
import json
import sys


def measure(streams: int, blocks: int, seed: int) -> dict:
    import numpy as np
    import torch

    from benchmarks.corpus import make_corpus
    from benchmarks.reference import syntax
    from ulcx_torch.codec.encoder import encode_stream_batched
    from ulcx_torch.utils.config import CodecConfig

    n = 2048
    cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=n)
    x = make_corpus(torch.Generator().manual_seed(seed), streams, blocks, 2, n, 44100, "cpu")
    enc, _ = encode_stream_batched(x, cfg, "cbr", rate_kbps=128)
    data, size = enc.data.numpy(), enc.size_bits.numpy()
    records, runs, mags, quants = (collections.Counter() for _ in range(4))
    pats, t_scales, s_scales, ends = (collections.Counter() for _ in range(4))
    run_len = collections.defaultdict(list)
    for b in range(streams):
        for t in range(blocks):
            blk = syntax.parse_block(syntax.nybbles_of(data[b, t, : size[b, t] // 8]), 0, n, 2)
            if blk.corrupt:
                raise AssertionError(f"stream {b} block {t} does not decode")
            if blk.wc & 0x8:
                pats[str(blk.wc >> 4)] += 1
                t_scales[str(blk.wc & 7)] += 1
            else:
                s_scales[str(blk.wc & 7)] += 1
            seg_start = True
            for kind, _ch, _p, cnt, a, q in blk.records:
                name = syntax.KIND_NAMES[kind]
                if kind in (syntax.STOP, syntax.STOP_NOISE, syntax.END):
                    ends[name] += 1
                    seg_start = True
                    continue
                quants[str(q)] += kind == syntax.QUANT
                if kind == syntax.QUANT and seg_start:
                    seg_start = False
                    continue
                records[name] += 1
                if kind == syntax.COEF:
                    mags[str(abs(a))] += 1
                elif cnt:
                    run_len[name].append(cnt)
    n_blocks = streams * blocks
    return {
        "measured_on": f"port CBR-128 stereo bs2048, corpus seed {seed}, {streams} streams x {blocks} blocks",
        "transient_share": sum(pats.values()) / n_blocks,
        "patterns": dict(pats), "transient_scales": dict(t_scales), "steady_scales": dict(s_scales),
        "records": dict(records),
        "run_means": {k: float(np.mean(v)) for k, v in run_len.items()},
        "coefficients": dict(mags), "quantizers": dict(quants),
        "subblock_ends": dict(ends),
        "stop_noise_share": ends["stop_noise"] / max(1, ends["stop"] + ends["stop_noise"]),
    }


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    print(json.dumps(measure(*(args + [32, 16, 1][len(args):])), indent=1, sort_keys=True))
