"""The port's layer spans (``utils/profiling.span``) on the CPU.

Under ``torch.profiler`` (CPU activity) an encode call and a decode call
open every span of their path, nested in time as their dotted names
nest: ``encode_stream_batched`` on a kernel-plan batch (B = 8) and on a
scan-plan batch (B = 6), each with as many ``size_round`` spans as its
plan prices rounds (2 a block step, and 6 at P = 512); the batched and
the pipelined decoders. With no profiler running, ``span`` builds no
``record_function`` (it raises here) and hands back one shared null
context. The tables built on a cache miss open a ``ulcx.build.*`` span
on their first call and none on a second identical call. bs256 stereo,
as the other port tests.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from ulcx_torch.bitstream import fast_encode
from ulcx_torch.codec import decoder, encoder, transform_batched
from ulcx_torch.graft_entry import bench_window, pack_streams
from ulcx_torch.ops import dct, scanutil
from ulcx_torch.utils import profiling
from ulcx_torch.utils.config import CodecConfig

CFG = CodecConfig(rate_hz=44100, n_chan=2, block_size=256)
RATE = {"rate_kbps": 128.0}
ENCODE = {"ulcx.encode": 1, "ulcx.encode.analysis": 1, "ulcx.encode.analysis.window_control": 1,
          "ulcx.encode.analysis.transform": 1, "ulcx.encode.analysis.psy_noise": 1,
          "ulcx.encode.bitstream": 1, "ulcx.encode.bitstream.prepare": 1,
          "ulcx.encode.bitstream.planes": 1, "ulcx.encode.bitstream.final": 1}
# size rounds a block step: the seeded ladder's classic and seeded rounds
# (walks (3, 3, 2, 1)); the exact ladder's ceil(log16 512) = 3 rounds of
# two eight-candidate halves ((7, 7, 6, 1))
SIZE_ROUNDS = {8: 2, 6: 6}
DECODE = ("ulcx.decode.tokens", "ulcx.decode.fsm_place", "ulcx.decode.expand",
          "ulcx.decode.imdct", "ulcx.decode.ms")


def _pcm(b: int, t: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(b * 100 + t)
    return torch.randn(b, t, 2, 256, generator=g) * 0.1


def _traced(fn):
    """(fn's result, [(name, start, end)] of the ulcx spans it opened)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.name.startswith("ulcx.")]


def _counts(spans) -> dict:
    out = {}
    for name, _, _ in spans:
        out[name] = out.get(name, 0) + 1
    return out


def _check_nesting(spans) -> None:
    """Each layer span lies inside its dotted parent as the innermost
    layer span that holds it; a top-level name inside none."""
    layers = [s for s in spans if not s[0].startswith("ulcx.build.")]
    for s in layers:
        holders = [h for h in layers if h is not s and h[1] <= s[1] and s[2] <= h[2]]
        inner = max(holders, key=lambda h: (h[1], -h[2]))[0] if holders else None
        parent = s[0].rsplit(".", 1)[0]
        assert inner == (parent if parent.count(".") else None), (s, inner)


@pytest.fixture(scope="module")
def encoded():
    """A kernel-plan batch (B = 8, T = 2) warmed up, then traced."""
    x = _pcm(8, 2)
    encoder.encode_stream_batched(x, CFG, "cbr", **RATE)
    return _traced(lambda: encoder.encode_stream_batched(x, CFG, "cbr", **RATE)[0])


@pytest.mark.parametrize("b", sorted(SIZE_ROUNDS))
def test_encode_opens_each_span_nested_as_named(encoded, b):
    if b == 8:
        _, spans = encoded
        t = 2
    else:
        x = _pcm(b, 1)
        encoder.encode_stream_batched(x, CFG, "cbr", **RATE)
        _, spans = _traced(lambda: encoder.encode_stream_batched(x, CFG, "cbr", **RATE))
        t = 1
    want = {k: (1 if k == "ulcx.encode" else t * v) for k, v in ENCODE.items()}
    want["ulcx.encode.bitstream.size_round"] = t * SIZE_ROUNDS[b]
    assert _counts(spans) == want
    _check_nesting(spans)


@pytest.fixture(scope="module")
def streams(encoded):
    enc, _ = encoded
    sizes, data = enc.size_bits.numpy(), enc.data.numpy()
    win = bench_window(sizes)
    return torch.from_numpy(pack_streams(sizes, data, win)), win, sizes


@pytest.mark.parametrize("path", ["batched", "pipelined"])
def test_decode_opens_each_span_nested_as_named(streams, path):
    s, win, sizes = streams
    if path == "batched":
        def call():
            return decoder.decode_stream_batched(s, 2, win, CFG)[1]
        want = {"ulcx.decode": 1, **{k: 2 for k in DECODE}}
    else:
        def call():
            return decoder.decode_stream_pipelined(s[0], 2, win, CFG, device="cpu")[1][None]
        want = {"ulcx.decode": 1, "ulcx.decode.tokens": 2, "ulcx.decode.fsm_place": 2,
                "ulcx.decode.expand": 1, "ulcx.decode.imdct": 2, "ulcx.decode.ms": 1}
    call()
    bits, spans = _traced(call)
    assert ((bits.numpy() + 7) & ~7 == sizes[: bits.shape[0]]).all()
    assert _counts(spans) == want
    _check_nesting(spans)


def test_untraced_calls_build_no_record(monkeypatch, streams):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("ulcx.encode") is profiling.span("ulcx.decode")
    s, win, sizes = streams
    enc, _ = encoder.encode_stream_batched(_pcm(8, 1), CFG, "cbr", **RATE)
    assert enc.size_bits.shape == (8, 1)
    _, bits, corrupt = decoder.decode_stream_batched(s, 2, win, CFG)
    assert not corrupt.any() and ((bits.numpy() + 7) & ~7 == sizes).all()


def test_tables_built_once_open_build_spans_once():
    for cached in (dct._matrices, dct._fact_consts_on, transform_batched.device_tables,
                   scanutil._ema_consts, fast_encode._prep_tables):
        cached.cache_clear()
    x = _pcm(8, 1)

    def call():
        return encoder.encode_stream_batched(x, CFG, "cbr", **RATE)

    _, first = _traced(call)
    builds = {n for n in _counts(first) if n.startswith("ulcx.build.")}
    assert builds == {"ulcx.build.dct_matrices", "ulcx.build.device_tables",
                      "ulcx.build.ema_consts", "ulcx.build.prep_tables"}
    _, second = _traced(call)
    assert not [n for n, _, _ in second if n.startswith("ulcx.build.")]
