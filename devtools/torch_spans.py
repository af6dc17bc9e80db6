"""A cell's traced run put down to the port's layer spans, on a card.

    python3 devtools/torch_spans.py [--seconds S] CELL SEED [SEED ...]
    python3 devtools/torch_spans.py --setup CELL

Run from a checkout's root (the ``benchmarks`` and ``ulcx_torch`` found
there are the ones measured). The first form runs ``benchmarks.run``
with ``--trace 1`` once a seed in this process, keeps the traced
window's Chrome trace and prints, a block step (encode) or a decoded
block (decode): for each ``ulcx.*`` span its device ms (with the span
innermost, and with its children), device activities launched, host
self ms and device-idle ms (``benchmarks.spans``); the spans' share of
the device time; the four layer times of ``benchmarks.spans.
LAYER_METRICS`` beside the harness's per-layer metrics; the runtime
calls that can wait for the device inside the window, each put down to
the span it ran in; and the traced calls' wall time beside the median
of the untraced ones. ``--setup`` splits a
cell's set-up in a fresh process: interpreter and imports, the CUDA
context, the inputs, then the first call under ``torch.profiler``
(its ``ulcx.build.*`` spans) and a second, untraced call. Every run's
numbers also go to ``chiprun_out/spans/<cell>.<seed or setup>.json``.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, os.getcwd())
OUT = Path("chiprun_out") / "spans"
WAITS = ("Synchronize", "cudaMemcpy")  # runtime calls that can wait for the device


def _save(name: str, res: dict) -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{name}.json").write_text(json.dumps(res, indent=1))


def traced_run(cell: str, seed: int, seconds: float, device=None, root=None) -> dict:
    """One traced run of ``cell`` (``device`` and ``root`` as ``benchmarks.run.main``
    takes them: a test's CPU and benchmark copy)."""
    import benchmarks.loop as loop
    import benchmarks.trace as trace
    from benchmarks import run, spans

    got = {}
    reduce0, loop0 = trace.reduce, loop.closed_loop

    def reduce(events, steps, params):
        got.update(events=events, steps=steps, params=params)
        return reduce0(events, steps, params)

    def closed_loop(call, secs, tracer=None, traced_calls=1):
        got["traced_calls"] = traced_calls
        got["window"] = loop0(call, secs, tracer, traced_calls)
        return got["window"]

    trace.reduce, loop.closed_loop = reduce, closed_loop
    res = {}
    try:
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", "1"], device=device, root=root, out=res)
    finally:
        trace.reduce, loop.closed_loop = reduce0, loop0
    if rc != 0 or "events" not in got:
        return {"cell": cell, "seed": seed, "rc": rc}

    events, steps, path = got["events"], got["steps"], got["params"]["path"]
    sp = spans.attribute(events)
    att = sp.attributed
    names = sorted(set(sp.spans) | {s for s, _, _ in att})
    table = {}
    for name in names:
        mine = [(k, us) for s, k, us in att if s == name]
        top = {}
        for k, us in mine:
            top[trace.short_name(k)] = top.get(trace.short_name(k), 0.0) + us
        h = sp.spans.get(name, {})
        table[name] = {
            "device_ms": sum(us for _, us in mine) / 1e3 / steps,
            "device_ms_with_children": spans.device_us(att, name) / 1e3 / steps if name else None,
            "launches": len(mine) / steps,
            "count": h.get("count", 0) / steps,
            "host_self_ms": h.get("host_self_us", 0.0) / 1e3 / steps,
            "idle_ms": h.get("idle_us", 0.0) / 1e3 / steps,
            "top": [[k, v / 1e3 / steps] for k, v in sorted(top.items(), key=lambda kv: -kv[1])[:6]],
        }
    w0, w1 = spans.traced_window(events)
    by_tid = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith(spans.PREFIX):
            by_tid.setdefault(e.get("tid"), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    waits = {}  # "<innermost span>: <runtime call>" -> calls in the window
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") in spans.LAUNCH_CATS and w0 <= float(e["ts"]) <= w1
                and any(x in e["name"] for x in WAITS)):
            owner = spans.innermost(by_tid.get(e.get("tid"), ()), float(e["ts"]))
            key = f"{owner[2] if owner else ''}: {e['name']}"
            waits[key] = waits.get(key, 0) + 1
    durs = got["window"].durations
    first = loop.TRACED_FROM
    traced = durs[first:first + got["traced_calls"]]
    untraced = durs[:first] + durs[first + got["traced_calls"]:]
    layer = {m: spans.layer_metric(m, att, steps, path) for m in spans.LAYER_METRICS}
    busy = res["device"]["busy_s"] * 1e3 / steps or float("nan")
    walks = res["metrics"].get("walks_ms_per_step", {}).get("value")
    parts = [layer.get("analysis_ms_per_step.encode"), layer.get("bitstream_glue_ms_per_step.encode"), walks]
    out = {
        "cell": cell, "seed": seed, "rc": rc, "correct": res["correct"], "steps": steps,
        "device": res["device"], "metrics": {k: v["value"] for k, v in res["metrics"].items()},
        "layer_metrics": layer, "busy_ms_per_step": busy, "coverage": spans.coverage(att),
        "encode_parts_over_busy": sum(parts) / busy if all(p is not None for p in parts) else None,
        "waits_in_window": waits, "traced_call_ms": [d * 1e3 for d in traced],
        "untraced_call_ms_median": statistics.median(untraced) * 1e3 if untraced else None,
        "spans": table, "breakdown": res.get("breakdown"),
    }
    _save(f"{cell}.{seed}", out)
    return out


def setup_split(cell: str) -> dict:
    t = {"start": T0}
    import torch

    t["import_torch"] = time.perf_counter()
    from benchmarks import bitgen, spec
    from benchmarks.corpus import make_corpus
    from ulcx_torch.codec import encoder
    from ulcx_torch.parallel.mesh import batch_decode
    from ulcx_torch.utils.config import CodecConfig

    t["import_port"] = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    t["cuda_context"] = time.perf_counter()

    bench = spec.load_benchmark()
    c = spec.cell(bench, cell)
    conf, traf = spec.config(c["config"]), spec.traffic(c["traffic"])
    cfg = CodecConfig(**conf["codec"])
    b, blocks = traf["streams"], traf["blocks_per_call"]
    if traf["kind"] == "encode":
        gen = torch.Generator(device=dev).manual_seed(1)
        pool = make_corpus(gen, b, blocks, cfg.n_chan, cfg.block_size, cfg.rate_hz, dev)

        def call():
            enc, _ = encoder.encode_stream_batched(pool, cfg, "cbr", rate_kbps=conf["rate_kbps"])
            enc.data.cpu(), enc.size_bits.cpu()
    else:
        import numpy as np

        rng = np.random.default_rng(1)
        uniq = traf["unique_streams"]
        nyb, count, _ = bitgen.generate_blocks(rng, uniq * blocks, cfg.block_size, cfg.n_chan,
                                               conf["budget_bits"], traf["mix"])
        streams, _, window = bitgen.pack_streams(nyb, count, uniq, blocks)
        pool = torch.from_numpy(streams[np.arange(b) % uniq]).to(dev)

        def call():
            batch_decode(pool, blocks, window, cfg, device=dev)
            torch.cuda.synchronize(dev)
    torch.cuda.synchronize(dev)
    t["inputs"] = time.perf_counter()

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        a = time.perf_counter()
        call()
        first = time.perf_counter() - a
    a = time.perf_counter()
    call()
    second = time.perf_counter() - a
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text())["traceEvents"]
    finally:
        os.unlink(path)
    builds = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith("ulcx.build."):
            builds[e["name"]] = builds.get(e["name"], 0.0) + float(e["dur"]) / 1e6
    keys = list(t)
    out = {"cell": cell, "device": torch.cuda.get_device_name(dev),
           "phases_s": {k: t[k] - t[p] for p, k in zip(keys, keys[1:])},
           "first_call_s_traced": first, "second_call_s": second, "build_spans_s": builds}
    _save(f"{cell}.setup", out)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 devtools/torch_spans.py")
    p.add_argument("cell")
    p.add_argument("seeds", nargs="*", type=int)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--setup", action="store_true")
    a = p.parse_args(argv)
    if a.setup:
        print(json.dumps(setup_split(a.cell)), flush=True)
        return 0
    for seed in a.seeds:
        res = traced_run(a.cell, seed, a.seconds)
        rows = res.pop("spans", {})
        res.pop("breakdown", None)
        print(json.dumps(res), flush=True)
        for name, r in rows.items():
            top = ", ".join(f"{k} {v:.3f}" for k, v in r["top"][:3])
            print(f"  {name or '(no span)':40s} dev {r['device_ms']:8.3f}"
                  f" all {r['device_ms_with_children'] or 0:8.3f} launches {r['launches']:7.2f}"
                  f" n {r['count']:5.2f} self {r['host_self_ms']:7.3f} idle {r['idle_ms']:6.3f}"
                  f" | {top}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
