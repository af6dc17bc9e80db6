"""Profiler hooks on ``torch.profiler`` (port of ``ulcx.utils.profiling``).

The reference's only observability is the tools' 0.5 s progress line
(reference tools/ulcEncodeTool.c:122-149); pass ``-profile:DIR`` to the
encode or decode tool (or use the context manager from library code) to
capture a trace of the encode or decode: host operations always, the
card's kernels when a card is present. The trace is a Chrome trace
(``*.pt.trace.json``) that TensorBoard's profiler plugin and
chrome://tracing load.

Such a trace carries the port's layer spans (``span``), ``user_annotation``
events on the profiler's own clock, the one the card's kernels and
copies are stamped on. Names are dotted, a parent's name the prefix of
its children's, and spans nest in time as their names nest:

- ``ulcx.encode`` (``codec.encoder``: a batched call, a block step, one
  ``encode_block``), with ``ulcx.encode.analysis`` and its
  ``.window_control``, ``.transform`` and ``.psy_noise``, and
  ``ulcx.encode.bitstream`` and its ``.prepare``, ``.planes``,
  ``.size_round`` (one span a round of eight candidates) and ``.final``;
- ``ulcx.decode`` (``codec.decoder``: a batched call, a pipelined call,
  one ``decode_block``), with ``ulcx.decode.tokens`` (the window gather
  and the nybble tokens), ``.fsm_place``, ``.expand``, ``.imdct`` and
  ``.ms`` (M/S and the offset update);
- ``ulcx.build.*``, on a cache miss only: ``library`` (the ``nvcc``
  build and the load), ``dct_matrices``, ``dct_fact_consts``,
  ``device_tables``, ``lap_tables``, ``lap_windows``, ``dct4_twiddles``,
  ``ema_consts``, ``prep_tables``.

A kernel in the trace belongs to the innermost span open on its
launching thread when its launch ran (the launch and the kernel share
``args.correlation``).
"""

from __future__ import annotations

import contextlib

import torch
from torch._C._autograd import _profiler_enabled

_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """Trace the region into ``trace_dir`` when it is set; else do nothing."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield


def span(name: str):
    """A named layer span (a context manager): ``torch.profiler.
    record_function(name)`` while a profiler records, else one shared
    null context after a check of the profiler's flag, so that an
    untraced call builds no record and enters no dispatcher. Neither
    form synchronises with the device or launches anything."""
    if not _profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


annotate = span  # ulcx's name of the same hook
