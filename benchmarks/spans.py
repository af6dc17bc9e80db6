"""The program's layer spans in a traced run's Chrome trace.

``ulcx_torch`` opens a ``user_annotation`` span, ``ulcx.<layer>...``, at
each layer boundary (``ulcx_torch/utils/profiling.py`` lists the names)
when a profiler records. ``attribute`` puts every device activity of the
``trace.WINDOW`` window (kernel, copy or set) down to the innermost such
span that was open on its launching thread when its launch ran: the
launch is the ``cuda_runtime`` or ``cuda_driver`` event with the same
``args.correlation``. An activity with no span open, or whose launch the
trace does not hold, goes to the span ``""``. It also gives each span
name its count, host time, host self time (less what its child spans
cover) and the device-idle time of the window spent in it, each idle gap
put down to the innermost span open at the gap's midpoint.

Names are dotted, so a layer's device time with its children's is the
sum over its name as a prefix (``device_us``). The per-layer times in
``LAYER_METRICS`` read so; ``benchmarks/trace.py``'s ``View`` does not
carry spans yet, so no reader under ``metrics/`` reads them (PERF.md §7).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from benchmarks.trace import DEVICE_CATS, WINDOW, _union

PREFIX = "ulcx."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WALKS = ("p1_kernel", "p2_kernel", "p3_kernel")

# metric -> (path, span prefix, kernels left out by name): device ms a
# block step (encode) or a decoded block (decode)
LAYER_METRICS = {
    "analysis_ms_per_step.encode": ("encode", "ulcx.encode.analysis", ()),
    "bitstream_glue_ms_per_step.encode": ("encode", "ulcx.encode.bitstream", WALKS),
    "tokens_ms_per_block.decode": ("decode", "ulcx.decode.tokens", ()),
    "imdct_ms_per_block.decode": ("decode", "ulcx.decode.imdct", ()),
}


@dataclass
class Spans:
    attributed: list                           # (span, activity name, us) of each device activity
    spans: dict = field(default_factory=dict)  # span -> {count, host_us, host_self_us, idle_us}


def traced_window(events):
    """(start, end) of the trace's ``trace.WINDOW`` annotation, in its microseconds."""
    marks = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW]
    if not marks:
        raise ValueError(f"the trace has no {WINDOW!r} span")
    return (min(float(e["ts"]) for e in marks),
            max(float(e["ts"]) + float(e["dur"]) for e in marks))


def innermost(spans, t):
    """The innermost of ``spans`` [(start, end, name)] open at ``t``: the
    latest start among those that hold it (nested spans), or None."""
    best = None
    for a, b, name in spans:
        if a <= t < b and (best is None or a > best[0] or (a == best[0] and b < best[1])):
            best = (a, b, name)
    return best


def attribute(events: list) -> Spans:
    """A Chrome trace's events -> the ``Spans`` of its traced window."""
    w0, w1 = traced_window(events)
    by_tid = {}    # thread -> [(start, end, name)] of its ulcx spans inside the window
    launches = {}  # correlation -> (thread, time of the launch)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat == "user_annotation" and e.get("name", "").startswith(PREFIX):
            a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
            if b > a:
                by_tid.setdefault(e.get("tid"), []).append((a, b, e["name"]))
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e.get("tid"), float(e["ts"]))

    out = Spans(attributed=[])
    device = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b <= a:
            continue
        device.append((a, b))
        launch = launches.get(e.get("args", {}).get("correlation"))
        owner = launch and innermost(by_tid.get(launch[0], ()), launch[1])
        out.attributed.append((owner[2] if owner else "", e["name"], b - a))

    def entry(name):
        return out.spans.setdefault(name, {"count": 0, "host_us": 0.0, "host_self_us": 0.0,
                                           "idle_us": 0.0})

    for spans in by_tid.values():
        open_ = []  # the spans that hold the current one, outermost first
        for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
            while open_ and open_[-1][1] <= a:
                open_.pop()
            d = entry(name)
            d["count"] += 1
            d["host_us"] += b - a
            d["host_self_us"] += b - a
            if open_:
                entry(open_[-1][2])["host_self_us"] -= b - a
            open_.append((a, b, name))

    every = [s for spans in by_tid.values() for s in spans]
    prev = w0
    for a, b in _union(device) + [[w1, w1]]:
        if a > prev:
            owner = innermost(every, (a + prev) / 2)
            entry(owner[2] if owner else "")["idle_us"] += a - prev
        prev = max(prev, b)
    return out


def device_us(attributed, prefix: str, exclude=()) -> float:
    """Device time of the activities under ``prefix`` (the span and its
    children), without those whose names hold any of ``exclude``."""
    return sum(us for s, name, us in attributed
               if (s == prefix or s.startswith(prefix + "."))
               and not any(x in name for x in exclude))


def coverage(attributed) -> float:
    """Share of the window's device time that a span launched."""
    total = sum(us for _, _, us in attributed)
    return sum(us for s, _, us in attributed if s) / total if total else 0.0


def layer_metric(name: str, attributed, steps: int, path: str):
    """``LAYER_METRICS[name]`` in ms a step, or None where the path is
    another or no activity falls under it."""
    want, prefix, exclude = LAYER_METRICS[name]
    if path != want:
        return None
    us = device_us(attributed, prefix, exclude)
    return us / 1e3 / steps if us > 0 else None
