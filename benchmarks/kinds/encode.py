"""Encode traffic: a closed loop of CBR ``encode_stream_batched`` calls
with the carry chained.

Traffic keys: ``streams`` a call, ``blocks_per_call``, ``pool_blocks``
(the corpus blocks each stream cycles through, made on the device from
the seed; a multiple of ``blocks_per_call``), ``warmup_calls``,
``traced_calls``, and ``check``: ``streams`` sampled for the comparison
and ``blocks`` of theirs whose coefficients are compared. Each call ends
when its bytes (up to the budget's) and sizes are in host memory.

Compared: blocks over the budget and the budget's unused share over
every block of the window (the rate search), the window controls of the
sampled streams' every window block (the analysis's transient
detection), and the sampled blocks' syntax and coefficients (the walks'
bytes, the transforms).
"""

from __future__ import annotations

import sys
import time


def run(ctx):
    import numpy as np
    import torch

    from benchmarks.corpus import make_corpus
    from benchmarks.loop import Outcome, closed_loop, memory_peak, sync
    from benchmarks.reference.checks import encode_numbers, window_mismatch
    from benchmarks.trace import Tracer
    from ulcx_torch.codec import encoder
    from ulcx_torch.utils.config import CodecConfig

    cfg = CodecConfig(**ctx.config["codec"])
    tr = ctx.traffic
    b, t, pool_len = tr["streams"], tr["blocks_per_call"], tr["pool_blocks"]
    c, n = cfg.n_chan, cfg.block_size
    rate, budget = ctx.config["rate_kbps"], ctx.config["budget_bits"]
    nbytes = -(-budget // 8)

    t_inputs = time.perf_counter()
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    pool = make_corpus(gen, b, pool_len, c, n, cfg.rate_hz, ctx.device)
    rng = np.random.default_rng(ctx.seed)
    sample = [int(s) for s in np.sort(rng.choice(b, min(tr["check"]["streams"], b), replace=False))]
    pcm = {s: pool[s].cpu().numpy() for s in sample}
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)

    kept = {s: [] for s in sample}   # (bytes, size_bits) of every block, from each stream's start
    state = {"carry": None, "g": 0, "over": 0, "bits": 0, "blocks": 0, "timed": False}

    def call(_):
        j = (state["g"] * t) % pool_len
        enc, state["carry"] = encoder.encode_stream_batched(pool[:, j:j + t], cfg, "cbr",
                                                            carry=state["carry"], rate_kbps=rate)
        data, size = enc.data[..., :nbytes].cpu().numpy(), enc.size_bits.cpu().numpy()
        if state["timed"]:
            state["over"] += int(np.sum(size > budget))
            state["bits"] += int(np.sum(size))
            state["blocks"] += size.size
        for s in sample:
            kept[s].extend((data[s, k].copy(), int(size[s, k])) for k in range(t))
        state["g"] += 1

    t_warm = time.perf_counter()
    for i in range(tr["warmup_calls"]):
        call(i)
    sync(ctx.device)
    print(f"set-up: start to inputs {t_inputs - ctx.t0:.3f} s, inputs {t_warm - t_inputs:.3f} s, "
          f"warm-up calls {time.perf_counter() - t_warm:.3f} s", file=sys.stderr)
    warm = state["g"]
    state["timed"] = True
    tracer = Tracer(ctx.device.type == "cuda") if ctx.trace else None
    win = closed_loop(call, ctx.seconds, tracer, tr["traced_calls"])
    print(win.summary(), file=sys.stderr)
    peak = memory_peak(ctx.device)
    del pool, state["carry"]
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    # the comparison: a sample of the window's blocks, each with a block after it
    first, last = warm * t, (warm + win.calls) * t - 1
    picks = rng.choice(len(sample) * (last - first), min(tr["check"]["blocks"], len(sample) * (last - first)),
                       replace=False)
    checked = sorted((sample[k // (last - first)], first + k % (last - first)) for k in picks)
    got = encode_numbers(kept, pcm, checked, n, c)
    wc_mismatch = window_mismatch(kept, pcm, first, last + 1, cfg.rate_hz)
    lim = ctx.limits
    checks = [("over_budget", state["over"], lim["over_budget"]),
              ("budget_shortfall", 1.0 - state["bits"] / (budget * state["blocks"]), lim["budget_shortfall"]),
              ("wc_mismatch", wc_mismatch, lim["wc_mismatch"]),
              ("bad_blocks", got["bad_blocks"], lim["bad_blocks"]),
              ("requant_mismatch", got["requant_mismatch"], lim["requant_mismatch"])]

    view = None
    if tracer is not None:
        view = tracer.view(tr["traced_calls"] * t, {"path": "encode", "streams": b, "positions": c * n})
    seconds_audio = win.calls * b * t * n / cfg.rate_hz
    e2e = {"encode_rtf": seconds_audio / (win.end - win.start),
           "encode_call_p95_ms": win.p95_ms(),
           "setup_s": win.start - ctx.t0}
    return Outcome(attempted=win.calls, failed=0, e2e=e2e, checks=checks, memory_peak_bytes=peak,
                   view=view)
