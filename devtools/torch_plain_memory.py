#!/usr/bin/env python3
"""Peak memory of the PyTorch port's plain encode walks at a path-sized batch.

    python3 devtools/torch_plain_memory.py [B] [BLOCK_SIZE]   # repo root; one CUDA GPU

The plain walks (``encode_kernels.*_plain``) are the CPU path, the
``use_pallas="off"`` path and the kernels' oracle. This script builds the
planes of one CBR block step (the second block) of B streams (256 by
default) of stereo ``bench.make_corpus`` at BLOCK_SIZE (32768: P =
65,536) on the card, as ``chip_smoke.py`` phase 3 does, runs every
walk's kernel there, then each plain walk once on the CPU and once on
the card, and prints one JSON line with each walk's seconds and peak
memory above what was held before it: on the CPU the resident set's
growth (sampled every 2 ms from ``/proc/self/statm``; pages an earlier
walk freed count as no growth, so a lower bound), on the card
``torch.cuda.max_memory_allocated``. Every plain output must equal the
kernel's on the whole batch, on the card exactly; on the CPU p1's zone
quantizer may differ by one step where its ``log`` (not the card's
``logf``) rounds across an integer, and the line counts those entries
and the magnitudes of their streams whose quantizer the two ``log``s
put apart. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def cpu_peak(fn, args):
    """(output, seconds, peak resident bytes above the start) of fn(*args)."""
    base, peak, done = rss_bytes(), [0], threading.Event()

    def sample():
        while not done.is_set():
            peak[0] = max(peak[0], rss_bytes())
            time.sleep(0.002)

    th = threading.Thread(target=sample)
    th.start()
    t0 = time.perf_counter()
    try:
        out = fn(*args)
    finally:
        secs = time.perf_counter() - t0
        done.set()
        th.join()
    return out, secs, max(peak[0], rss_bytes()) - base


def card_peak(fn, args):
    """(output, seconds, peak allocated bytes above the start) of fn(*args)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base


def quantizer(m):
    """p1's zone quantizer of magnitudes m (as ``encode_kernels._p1_zones``)."""
    import torch

    from ulcx_torch.bitstream import encode_kernels as ek

    x = torch.floor(ek._BQ_A - ek._INV_LN2 * torch.log(torch.clamp(m, min=1e-38)))
    return torch.clamp(x, 5.0, 31.0).to(torch.int32)


def log_steps(got, want, coef) -> dict:
    """Where p1's s12 on the CPU (got) differs from the kernel's (want):
    the entries, their streams, the largest quantizer step, whether a
    split bit differs, and the magnitudes of those streams whose
    quantizer differs between the CPU's log and the card's."""
    import torch

    diff = got != want
    streams = diff.any(dim=2).any(dim=0).nonzero().flatten()
    mags = coef.abs()[:, streams].flatten()
    mags = torch.unique(mags[mags >= 2.0**-126])
    return {"entries": int(diff.sum()), "streams": streams.tolist(),
            "max_qi_step": int(((got & 31) - (want & 31)).abs().max()),
            "split_differs": bool(((got ^ want) & 32).any()),
            "magnitudes_apart": int((quantizer(mags) != quantizer(mags.cuda()).cpu()).sum())}


def main(b: int, bs: int) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_plain_memory: no CUDA device", file=sys.stderr)
        return 1
    sys.modules["jax"] = None
    sys.modules["ulcx"] = None
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from bench import make_corpus
    from ulcx_torch.bitstream import encode_kernels as ek
    from ulcx_torch.bitstream import fast_encode as fe
    from ulcx_torch.codec.encoder import max_block_bytes
    from ulcx_torch.utils.config import CodecConfig

    card = cs.card_line()
    print(card, flush=True)
    cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=bs)
    blk, _ = cs.analyze(make_corpus(b, 2, bs), cfg, "cuda")  # the second block's planes
    pl = fe.make_planes(fe.prepare_fast(blk, cfg))
    steps = torch.arange(1, fe.N_CAND + 1, dtype=torch.int32, device="cuda")
    nn = torch.minimum(((blk.n_nz[:, None] + fe.N_CAND - 1) // fe.N_CAND) * steps,
                       blk.n_nz[:, None]).to(torch.int32)
    t, c = fe._tc_of(pl, nn)
    s12 = ek.p1(t, c, pl.key, pl.coef, pl.aux)
    state = ek.p2(t, c, pl.key, pl.thr, pl.aux, s12)
    n_words = max_block_bytes(cfg) // 4
    walks = {
        "p1": (ek.p1, ek.p1_plain, (t, c, pl.key, pl.coef, pl.aux)),
        "p2": (ek.p2, ek.p2_plain, (t, c, pl.key, pl.thr, pl.aux, s12)),
        "p3_size": (ek.p3_size, ek.p3_size_plain, (pl.thr, pl.aux, state)),
        "p3_materialize": (ek.p3_materialize, ek.p3_materialize_plain,
                           (pl.coef, pl.ampn, pl.hfamp, pl.hfmeta, pl.aux, state, pl.hdr,
                            n_words)),
    }
    rows = {}
    for name, (kernel, plain, args) in walks.items():
        want = kernel(*args)
        want = want if isinstance(want, tuple) else (want,)
        host = tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)
        row = {}
        for where, measure, a in (("cpu", cpu_peak, host), ("card", card_peak, args)):
            got, secs, peak = measure(plain, a)
            got = got if isinstance(got, tuple) else (got,)
            row[f"{where}_s"], row[f"{where}_peak_gib"] = secs, peak / 2**30
            if not all(torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want)):
                if where == "card" or name != "p1":
                    raise AssertionError(f"{name}: plain on the {where} differs from the kernel")
                steps = log_steps(got[0], want[0].cpu(), host[3])
                print(f"p1 on the cpu: {steps}", flush=True)
                if steps["max_qi_step"] > 1 or steps["split_differs"] or not steps["magnitudes_apart"]:
                    raise AssertionError("p1: plain on the cpu differs from the kernel other than "
                                         "by a log rounding")
                row["cpu_log_steps"] = steps["entries"]
            del got
        rows[name] = row
        print(f"{name} B={b} P={2 * bs}: plain against the kernel on all streams; "
              + ", ".join(f"{k} {v:.3f}" for k, v in row.items()) + f" [{card}]", flush=True)
    print(json.dumps({"card": card, "b": b, "p": 2 * bs,
                      "plain_chunk_bytes": ek.PLAIN_CHUNK_BYTES, "walks": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 256,
                  int(sys.argv[2]) if len(sys.argv) > 2 else 32768))
