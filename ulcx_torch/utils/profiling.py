"""Profiler hooks on ``torch.profiler`` (port of ``ulcx.utils.profiling``).

The reference's only observability is the tools' 0.5 s progress line
(reference tools/ulcEncodeTool.c:122-149); pass ``-profile:DIR`` to the
encode or decode tool (or use the context manager from library code) to
capture a trace of the encode or decode: host operations always, the
card's kernels when a card is present. The trace is a Chrome trace
(``*.pt.trace.json``) that TensorBoard's profiler plugin and
chrome://tracing load.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """Trace the region into ``trace_dir`` when it is set; else do nothing."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield


def annotate(name: str):
    """Named sub-region inside a trace (a context manager)."""
    import torch

    return torch.profiler.record_function(name)
