"""Run one cell of the benchmark of ``ulcx_torch`` once.

    python3 -m benchmarks.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA devices.
The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; their files under ``benchmarks/`` say what to run, and the
traffic's ``kind`` which call shape drives it. The run makes its inputs
on the device from the seed, warms up the cell's shapes, runs the
closed loop for ``--seconds``, then compares a sample of what the timed
calls produced with the plain reference under ``benchmarks/reference``.
It prints each number compared beside its limit on standard error, and
as the last line of standard output one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace
1`` ``breakdown``, and last ``compared``.

Exit codes: 0 a result was printed; 2 bad arguments; 3 no CUDA device,
or fewer than the cell asks for; 4 the JAX package or JAX was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ulcx")


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _args(argv):
    p = argparse.ArgumentParser(prog="python3 -m benchmarks.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _guard(when: str) -> bool:
    bad = forbidden_modules()
    if bad:
        print(f"error: {', '.join(bad)} loaded {when}; the benchmark runs the PyTorch port alone",
              file=sys.stderr)
    return not bad


def main(argv=None, *, device=None, root=None, tf32: bool = False, out=None) -> int:
    """One run. ``device`` (tests: the CPU) skips the look for CUDA
    devices; ``tf32`` lets the GEMMs run in TF32 (the control, which the
    benchmark's own runs never do); ``out`` receives the result's dict."""
    from benchmarks import spec

    args = _args(argv)
    root = root or spec.HERE
    checkout = root.parent
    # every cache the program or PyTorch keeps, at fixed paths in the checkout
    os.environ["TRITON_CACHE_DIR"] = str(checkout / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(checkout / "build" / "torch_extensions")

    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, args.workload)
    conf = spec.config(cell["config"], root)
    traf = spec.traffic(cell["traffic"], root)
    kind = spec.kind(traf["kind"], root)
    from benchmarks.loop import Context

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"error: {args.workload} needs {cell['chips']} CUDA device(s), found {have}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    if not _guard("at start"):
        return 4

    ctx = Context(cell=cell, config=conf, traffic=traf, limits=spec.limits(cell["name"], root),
                  seed=args.seed % (1 << 63), seconds=args.seconds, trace=bool(args.trace),
                  device=device, t0=T0)
    res = kind.run(ctx)
    if not _guard("once the window closed"):
        return 4

    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    if args.trace:
        for m in spec.per_layer_for(bench, cell["name"]):
            v = spec.reader(m["name"], root)(res.view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        for m in bench["end_to_end"]:
            if spec.applies(m, cell["name"]):
                metrics[m["name"]] = {"value": res.e2e[m["name"]], "unit": m["unit"]}

    correct = all(v <= lim for _, v, lim in res.checks)
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": res.memory_peak_bytes}
    result = {"correct": correct, "attempted": res.attempted, "failed": res.failed,
              "metrics": metrics, "device": device_info}
    if args.trace:
        device_info["busy_s"] = res.view.busy_us / 1e6
        device_info["window_s"] = res.view.window_us / 1e6
        result["breakdown"] = {"device_ops": res.view.device_ops, "idle_gaps": res.view.idle_gaps}
    result["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in res.checks}
    for name, v, lim in res.checks:
        print(f"compared {name}: {v!r} (limit {lim!r}) {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    if out is not None:
        out.update(result)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
