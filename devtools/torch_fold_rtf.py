#!/usr/bin/env python3
"""What ``fold_bitstream`` and ``flat_stream`` do to the PyTorch port's
encode realtime factor and memory, on one card.

    python3 devtools/torch_fold_rtf.py [ROUNDS [RUNS]]      # from the repo root; one CUDA GPU
    python3 devtools/torch_fold_rtf.py --memory [T]
    python3 devtools/torch_fold_rtf.py --one VARIANT [RUNS [T]]

Default: ``batch_encode`` CBR-128 of B=512 streams x T=8 blocks of stereo
bs2048 ``bench.make_corpus`` in three variants: ``loop`` (the per-block
loop, the default), ``fold8`` (``fold_bitstream=8``) and ``flat``
(``flat_stream=True``). Each variant runs as a process of its own
(``--one``), ROUNDS times (5 by default), the order rotating from round
to round so that no variant always follows the same neighbour; a
process's figure is the median of its RUNS warm runs (7 by default),
each ending in a synchronise. Prints every round, then per variant the
median over its processes, its ratio to ``loop``'s, the rounds it won
against ``loop``, ``loop``'s quartiles (the spread a difference has to
exceed) and the peak device memory; checks that ``fold8`` gave ``loop``'s
bytes and ``flat`` its window control (its sizes differ where the
transform's rounding at the larger batch flips a near-tie: the totals
are printed); then one JSON line with all of it.

``--memory``: the same encode at T blocks (64 by default), one process
and one run per variant ``fold8``, ``fold16``, ``fold32``, ``fold64`` and
``flat``; prints each one's peak device memory
(``torch.cuda.max_memory_allocated``) and realtime factor, or that it
ran out of memory. Imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, BS, RATE_KBPS = 512, 8, 2048, 128.0
VARIANTS = ("loop", "fold8", "flat")
MEMORY_VARIANTS = ("fold8", "fold16", "fold32", "fold64", "flat")


def variant_config(variant: str):
    from ulcx_torch.utils.config import CodecConfig

    kw = {}
    if variant == "flat":
        kw["flat_stream"] = True
    elif variant.startswith("fold"):
        kw["fold_bitstream"] = int(variant[4:])
    elif variant != "loop":
        raise ValueError(f"unknown variant {variant!r}")
    return CodecConfig(rate_hz=44100, n_chan=2, block_size=BS, **kw)


def one(variant: str, runs: int, t: int) -> int:
    """Child: one variant, ``runs`` warm runs; prints one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("torch_fold_rtf: no CUDA device", file=sys.stderr)
        return 1
    sys.modules["jax"] = None
    sys.modules["ulcx"] = None
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from bench import make_corpus
    from ulcx_torch._build import launch_counts, reset_launch_counts
    from ulcx_torch.parallel.mesh import batch_encode

    cfg = variant_config(variant)
    blocks = torch.from_numpy(make_corpus(B, t, BS)).cuda()
    reset_launch_counts()
    out, _ = batch_encode(blocks, cfg, "cbr", rate_kbps=RATE_KBPS)  # builds and warms up
    torch.cuda.synchronize()
    counts = launch_counts()
    cs.check_encoded(out.size_bits, out.data, B, t, cfg, variant)
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out, _ = batch_encode(blocks, cfg, "cbr", rate_kbps=RATE_KBPS)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    audio_s = B * t * BS / cfg.rate_hz
    sha = {name: hashlib.sha256(getattr(out, name).cpu().contiguous().numpy().tobytes()).hexdigest()
           for name in ("size_bits", "window_ctrl", "data")}
    print(json.dumps({"card": cs.card_line(), "variant": variant, "t": t,
                      "rtf": [audio_s / s for s in secs], "launches": counts,
                      "total_bits": int(out.size_bits.sum()),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30, **sha}), flush=True)
    return 0


def child(variant: str, runs: int, t: int) -> dict:
    """One ``--one`` process; {"failed": reason} when it did not finish."""
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", variant, str(runs),
                          str(t)], cwd=HERE, capture_output=True, text=True, timeout=1800)
    if out.returncode != 0:
        err = out.stderr.strip().splitlines()
        return {"variant": variant, "failed": err[-1] if err else f"exit code {out.returncode}",
                "out_of_memory": "OutOfMemoryError" in out.stderr}
    return json.loads(out.stdout.strip().splitlines()[-1])


def pairs(rounds: int, runs: int) -> int:
    rows = []
    for i in range(rounds):
        order = VARIANTS[i % 3:] + VARIANTS[: i % 3]
        row = {}
        for v in order:
            row[v] = child(v, runs, T)
            if "failed" in row[v]:
                raise RuntimeError(f"{v} failed: {row[v]['failed']}")
            row[v]["median"] = statistics.median(row[v]["rtf"])
        rows.append(row)
        if any(row["fold8"][k] != row["loop"][k] for k in ("data", "size_bits")):
            raise AssertionError("fold8's bytes or sizes differ from the block loop's")
        for v in ("fold8", "flat"):
            if row[v]["window_ctrl"] != row["loop"]["window_ctrl"]:
                raise AssertionError(f"{v}'s window control differs from the block loop's")
        print(f"round {i} ({', '.join(order)}) [{row['loop']['card']}]: " +
              "; ".join(f"{v} {row[v]['median']:.1f}x" for v in VARIANTS) +
              f"; total bits loop {row['loop']['total_bits']}, flat {row['flat']['total_bits']}",
              flush=True)
    summary = {"card": rows[0]["loop"]["card"], "b": B, "t": T, "rounds": rounds, "runs": runs}
    base = [r["loop"]["median"] for r in rows]
    q1, _, q3 = statistics.quantiles(base, n=4) if len(base) > 1 else (base[0],) * 3
    for v in VARIANTS:
        med = [r[v]["median"] for r in rows]
        summary[v] = {"process_medians": med, "median": statistics.median(med),
                      "ratio_to_loop": statistics.median(med) / statistics.median(base),
                      "rounds_ahead_of_loop": sum(m > b for m, b in zip(med, base)),
                      "peak_gib": max(r[v]["peak_gib"] for r in rows),
                      "launches": rows[0][v]["launches"]}
        print(f"{v}: median {summary[v]['median']:.1f}x ({summary[v]['ratio_to_loop']:.3f}x loop), "
              f"ahead of loop in {summary[v]['rounds_ahead_of_loop']} of {rounds} rounds, peak "
              f"{summary[v]['peak_gib']:.2f} GiB, launches {summary[v]['launches']}", flush=True)
    summary["loop_q1"], summary["loop_q3"] = q1, q3
    print(f"loop quartiles {q1:.1f}x-{q3:.1f}x", flush=True)
    print(json.dumps(summary), flush=True)
    return 0


def memory(t: int) -> int:
    rows = []
    for v in MEMORY_VARIANTS:
        r = child(v, 1, t)
        rows.append(r)
        if "failed" in r:
            print(f"B={B} T={t} {v}: {'out of memory' if r['out_of_memory'] else 'failed'}: "
                  f"{r['failed']}", flush=True)
        else:
            print(f"B={B} T={t} {v}: peak {r['peak_gib']:.2f} GiB, {r['rtf'][0]:.1f}x realtime, "
                  f"launches {r['launches']} [{r['card']}]", flush=True)
    print(json.dumps({"b": B, "t": t, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    argv = sys.argv[1:]
    if argv[:1] == ["--one"]:
        sys.exit(one(argv[1], int(argv[2]) if len(argv) > 2 else 7,
                     int(argv[3]) if len(argv) > 3 else T))
    if argv[:1] == ["--memory"]:
        sys.exit(memory(int(argv[1]) if len(argv) > 1 else 64))
    sys.exit(pairs(int(argv[0]) if argv else 5, int(argv[1]) if len(argv) > 1 else 7))
