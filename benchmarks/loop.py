"""The closed loop that every call shape runs, and what a run hands back.

A closed loop sends its next call when the last one has returned: one
caller that waits for each reply, as a batch job or a CLI tool does.
Each call ends where its results are usable: bytes and sizes in host
memory, or the device synchronised. The window opens with the first
timed call and closes after the first call that ends past ``seconds``
(and not before MIN_CALLS calls, so that a slow call shape still has
calls to compare); every call in it counts, and a rate is taken over
all of them and all of that time.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field


MIN_CALLS = 3
TRACED_FROM = 2  # the first traced call: past the window's first, which may still settle


@dataclass
class Context:
    """One run's inputs, from the command line and the cell's files."""

    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object      # torch.device
    t0: float           # perf_counter at process start (setup_s counts from it)


@dataclass
class Outcome:
    attempted: int
    failed: int
    e2e: dict                                   # end-to-end metric -> value
    checks: list = field(default_factory=list)  # (name, value, limit): correct when value <= limit
    memory_peak_bytes: int = 0
    view: object = None                         # trace.View of a traced run


@dataclass
class Window:
    durations: list      # seconds of each call
    start: float
    end: float

    @property
    def calls(self) -> int:
        return len(self.durations)

    def summary(self) -> str:
        """The calls' count and quartiles, for standard error."""
        q = statistics.quantiles(self.durations, n=4) if self.calls > 1 else self.durations * 3
        return (f"window: {self.calls} calls in {self.end - self.start:.3f} s, call ms quartiles "
                f"{q[0] * 1e3:.2f} / {q[1] * 1e3:.2f} / {q[2] * 1e3:.2f}, max {max(self.durations) * 1e3:.2f}")

    def p95_ms(self) -> float:
        if len(self.durations) < 2:
            return max(self.durations) * 1e3
        return statistics.quantiles(self.durations, n=20)[-1] * 1e3


def closed_loop(call, seconds: float, tracer=None, traced_calls: int = 1) -> Window:
    """Run ``call(i)`` back to back for ``seconds``. With a tracer,
    calls TRACED_FROM .. TRACED_FROM + traced_calls - 1 are traced (the
    window is kept open until they have run)."""
    durs = []
    start = time.perf_counter()
    deadline = start + seconds
    i = 0
    while True:
        if tracer is not None and i == TRACED_FROM:
            tracer.start()
        a = time.perf_counter()
        call(i)
        b = time.perf_counter()
        durs.append(b - a)
        if tracer is not None and i == TRACED_FROM + traced_calls - 1:
            tracer.stop()
        i += 1
        if b >= deadline and i >= MIN_CALLS and (tracer is None or i >= TRACED_FROM + traced_calls):
            return Window(durs, start, b)


def memory_peak(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
