"""The traced run's device timeline, and what the per-layer readers see.

``Tracer`` runs ``torch.profiler`` (host operations and the card's
kernels) around a fixed number of steady calls inside the window and
reads back its Chrome trace. ``reduce`` turns the trace into a ``View``:
the kernels that ran inside the traced calls, the union of every device
activity's interval (busy time, not a sum of kernel times, which would
count overlapping work twice), the idle gaps between them named by the
innermost host operation running at the time, and the parameters the
readers divide by.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "bench.traced_calls"


@dataclass
class View:
    """What a per-layer metric's reader reads."""

    kernels: list            # (name, duration us) of each kernel in the traced calls
    busy_us: float           # union of device activity inside the traced window
    window_us: float         # the traced window on the host's clock
    steps: int               # block steps the traced calls ran (batched: per batch, not per stream)
    params: dict = field(default_factory=dict)  # path, batch, positions, plan, window_bytes, ...
    device_ops: list = field(default_factory=list)   # [name, seconds], most time first
    idle_gaps: list = field(default_factory=list)    # [name, seconds], longest first

    def kernel_us(self, *names: str) -> float:
        """Device time of the kernels whose names hold any of ``names``."""
        return sum(d for k, d in self.kernels if any(x in k for x in names))

    def gemm_us(self) -> float:
        return sum(d for k, d in self.kernels if "gemm" in k.lower())


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces
    and parameter list, at most 100 characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:100]


def _union(intervals):
    """Merged [(start, end)] of intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events: list, steps: int, params: dict) -> View:
    """A Chrome trace's events -> the View of its ``WINDOW`` annotation."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW]
    if not spans:
        raise ValueError(f"the trace has no {WINDOW!r} span")
    w0 = min(float(e["ts"]) for e in spans)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in spans)

    def inside(e):
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        return (a, b) if b > a else None

    device, kernels, ops = [], [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        iv = inside(e)
        if iv is None:
            continue
        device.append(iv)
        if e["cat"] == "kernel":
            kernels.append((e["name"], iv[1] - iv[0]))
        key = short_name(e["name"])
        ops[key] = ops.get(key, 0.0) + (iv[1] - iv[0])
    merged = _union(device)
    busy = sum(b - a for a, b in merged)

    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                   for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS),
                  key=lambda h: h[0])
    gaps, prev, nxt, active = {}, w0, 0, []
    for a, b in merged + [[w1, w1]]:
        if a > prev:
            # a sweep: the host operations open at the gap's midpoint
            mid = (a + prev) / 2
            while nxt < len(host) and host[nxt][0] <= mid:
                active.append(host[nxt])
                nxt += 1
            active = [h for h in active if h[1] >= mid]
            cover = [h for h in active if h[2] != WINDOW]
            name = min(cover, key=lambda h: h[1] - h[0])[2] if cover else "host, outside any operation"
            gaps[name] = gaps.get(name, 0.0) + (a - prev)
        prev = max(prev, b)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return View(kernels=kernels, busy_us=busy, window_us=w1 - w0, steps=steps, params=params,
                device_ops=[[k, v / 1e6] for k, v in top], idle_gaps=[[k, v / 1e6] for k, v in idle])


class Tracer:
    """Profiles the calls between ``start`` and ``stop``; ``view`` then
    reduces the trace. The trace file lives in the run's TMPDIR only
    while it is read."""

    def __init__(self, cuda: bool):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self._prof = profile(activities=acts)
        self._span = None

    def start(self):
        import torch

        self._prof.__enter__()
        self._span = torch.profiler.record_function(WINDOW)
        self._span.__enter__()

    def stop(self):
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    def view(self, steps: int, params: dict) -> View:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return reduce(events, steps, params)
