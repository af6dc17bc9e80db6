"""Decode traffic: a closed loop of ``batch_decode`` calls.

Traffic keys: ``streams`` a call, ``blocks_per_call`` decoded from each
stream's start, ``pool_batches`` distinct batches cycled call by call,
``unique_streams`` distinct streams in each batch (the batch repeats
them in an order drawn from the seed), ``mix`` (``bitgen``'s record
mix), ``warmup_calls``, ``traced_calls``, and ``check``: ``pcm_streams``
and ``pcm_calls``, the PCM sample kept for the comparison. The streams
are written by the benchmark's own plain writer (``bitgen``), not by the
port's encoder; the window is sized as the decode bench sizes it (the
largest block rounded up to 64 bytes, plus 64). Each call ends in a
device synchronise with the PCM on the device.
"""

from __future__ import annotations

import sys
import time


def run(ctx):
    import numpy as np
    import torch

    from benchmarks import bitgen
    from benchmarks.loop import Outcome, closed_loop, memory_peak, sync
    from benchmarks.reference.checks import decode_stream, nonfinite, pcm_gap
    from benchmarks.trace import Tracer
    from ulcx_torch.parallel.mesh import batch_decode
    from ulcx_torch.utils.config import CodecConfig

    cfg = CodecConfig(**ctx.config["codec"])
    tr = ctx.traffic
    b, t, n_pool, uniq = tr["streams"], tr["blocks_per_call"], tr["pool_batches"], tr["unique_streams"]
    c, n = cfg.n_chan, cfg.block_size
    t_inputs = time.perf_counter()
    rng = np.random.default_rng(ctx.seed)

    nyb, count, _ = bitgen.generate_blocks(rng, n_pool * uniq * t, n, c, ctx.config["budget_bits"], tr["mix"])
    streams, _, window = bitgen.pack_streams(nyb, count, n_pool * uniq, t)
    streams = streams.reshape(n_pool, uniq, -1)
    tiles = np.stack([rng.permutation(np.arange(b) % uniq) for _ in range(n_pool)])  # [pool, B]
    pool = [torch.from_numpy(streams[p][tiles[p]]).to(ctx.device) for p in range(n_pool)]
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)

    n_keep, r_keep = min(tr["check"]["pcm_streams"], b), tr["check"]["pcm_calls"]
    keep_streams = torch.as_tensor(np.sort(rng.choice(b, n_keep, replace=False)), device=ctx.device)
    state = {"g": 0, "timed": False}
    kept_bits, kept_pcm = [], {}   # (pool batch, bits, corrupt) of every timed call; a PCM sample

    def call(i):
        p = state["g"] % n_pool
        pcm, bits, corrupt = batch_decode(pool[p], t, window, cfg, device=ctx.device)
        sync(ctx.device)
        if state["timed"]:
            kept_bits.append((p, bits, corrupt))
            # a reservoir of PCM samples over the window, drawn from the seed
            slot = i if i < r_keep else int(rng.integers(0, i + 1))
            if slot < r_keep:
                kept_pcm[slot] = (p, pcm.index_select(0, keep_streams))
        state["g"] += 1

    t_warm = time.perf_counter()
    for i in range(tr["warmup_calls"]):
        call(i)
    sync(ctx.device)
    print(f"set-up: start to inputs {t_inputs - ctx.t0:.3f} s, inputs {t_warm - t_inputs:.3f} s, "
          f"warm-up calls {time.perf_counter() - t_warm:.3f} s", file=sys.stderr)
    state["timed"] = True
    tracer = Tracer(ctx.device.type == "cuda") if ctx.trace else None
    win = closed_loop(call, ctx.seconds, tracer, tr["traced_calls"])
    print(win.summary(), file=sys.stderr)
    peak = memory_peak(ctx.device)
    del pool
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference: every distinct stream's bits and corrupt flags, the
    # PCM of those the sample kept
    want_pcm = {(p, int(tiles[p][s])) for p, _ in kept_pcm.values() for s in keep_streams.tolist()}
    ref = {}
    for p in range(n_pool):
        for u in range(uniq):
            ref[p, u] = decode_stream(streams[p, u], t, n, c, (p, u) in want_pcm)
    ref_bits = {p: np.stack([ref[p, u][0] for u in tiles[p]]) for p in range(n_pool)}
    ref_corrupt = {p: np.stack([ref[p, u][1] for u in tiles[p]]) for p in range(n_pool)}
    mismatch = 0
    for p, bits, corrupt in kept_bits:
        mismatch += int(np.sum(bits.cpu().numpy() != ref_bits[p]))
        mismatch += int(np.sum(corrupt.cpu().numpy() != ref_corrupt[p]))
    gap, bad_samples = 0.0, 0
    for p, pcm in kept_pcm.values():
        pcm = pcm.cpu().numpy()
        bad_samples += nonfinite(pcm)
        for k, s in enumerate(keep_streams.tolist()):
            gap = max(gap, pcm_gap(pcm[k], ref[p, int(tiles[p][s])][2]))
    lim = ctx.limits
    checks = [("bits_corrupt_mismatch", mismatch, lim["bits_corrupt_mismatch"]),
              ("pcm_nonfinite", bad_samples, lim["pcm_nonfinite"]),
              ("pcm_gap", gap, lim["pcm_gap"])]

    view = None
    if tracer is not None:
        view = tracer.view(tr["traced_calls"] * t, {"path": "decode", "streams": b, "positions": c * n,
                                                    "window_bytes": window})
    e2e = {"decode_rtf": win.calls * b * t * n / cfg.rate_hz / (win.end - win.start),
           "decode_call_p95_ms": win.p95_ms(),
           "setup_s": win.start - ctx.t0}
    return Outcome(attempted=win.calls, failed=0, e2e=e2e, checks=checks, memory_peak_bytes=peak, view=view)
