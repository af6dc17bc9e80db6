"""The program's layer spans in a traced run (``benchmarks/spans.py``).

On a synthetic Chrome trace (runtime launches and the kernels and copies
they launched, sharing ``args.correlation``; nested ``ulcx.*`` spans on
the launching thread and one span on another thread; a kernel launched
outside any span, one whose launch the trace lacks, one that runs past
the window; idle gaps) ``attribute`` gives each activity its span, each
span its count, host and host self time and the idle time spent in it,
exactly, and the four layer times read what they should. The spans move
no number of ``benchmarks/trace.py``'s ``View`` but the names of idle
gaps that no host operation covered, so every existing reader reads the
same with and without them. ``devtools/torch_spans.py`` runs a cell's
kind through the harness on the CPU and puts its spans in a table; with
a card (``python -m pytest -m cuda benchmarks/tests/test_bench_spans.py``)
the spans launch at least 97 % of each cell's device time.
"""

from __future__ import annotations

import sys

import pytest
import torch
from bench_helpers import REPO, copy_benchmark

from benchmarks import spans, spec, trace

sys.path.insert(0, str(REPO / "devtools"))
import torch_spans  # noqa: E402

GEMM = "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize256x128x8"


def X(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _spans_of_encode():
    return [
        X("ulcx.encode", "user_annotation", 10, 890),
        X("ulcx.encode.analysis", "user_annotation", 20, 380),
        X("ulcx.encode.analysis.transform", "user_annotation", 30, 170),
        X("ulcx.encode.bitstream", "user_annotation", 410, 480),
        X("ulcx.encode.bitstream.size_round", "user_annotation", 420, 180),
        X("ulcx.encode.bitstream.size_round", "user_annotation", 610, 80),
        X("ulcx.decode", "user_annotation", 240, 20, tid=2),  # another thread's span
    ]


def _encode_trace(with_spans: bool = True):
    ev = [X(trace.WINDOW, "user_annotation", 0, 1000),
          X("aten::mm", "cpu_op", 810, 35),
          # launches on thread 1 and what they launched
          X("cudaMemcpyAsync", "cuda_runtime", 15, 2, corr=6), X("Memcpy HtoD", "gpu_memcpy", 20, 20, corr=6),
          X("cudaLaunchKernel", "cuda_runtime", 35, 2, corr=1), X(GEMM, "kernel", 100, 50, corr=1),
          X("cudaLaunchKernel", "cuda_runtime", 250, 2, corr=2),
          X("elementwise_kernel", "kernel", 260, 40, corr=2),
          X("cuLaunchKernel", "cuda_driver", 430, 2, corr=3), X("p1_kernel", "kernel", 440, 100, corr=3),
          X("cudaLaunchKernel", "cuda_runtime", 700, 2, corr=4),
          X("CatArrayBatchedCopy", "kernel", 705, 95, corr=4),
          X("cudaLaunchKernel", "cuda_runtime", 950, 2, corr=5), X("copy_kernel", "kernel", 955, 35, corr=5),
          X("orphan_kernel", "kernel", 850, 10, corr=99),
          X("cudaLaunchKernel", "cuda_runtime", 960, 2, corr=8), X("late_kernel", "kernel", 990, 20, corr=8)]
    return ev + (_spans_of_encode() if with_spans else [])


def test_attribute_is_exact_on_a_synthetic_trace():
    got = spans.attribute(_encode_trace())
    assert sorted(got.attributed) == sorted([
        ("ulcx.encode", "Memcpy HtoD", 20.0),
        ("ulcx.encode.analysis.transform", GEMM, 50.0),
        ("ulcx.encode.analysis", "elementwise_kernel", 40.0),   # not the other thread's span
        ("ulcx.encode.bitstream.size_round", "p1_kernel", 100.0),
        ("ulcx.encode.bitstream", "CatArrayBatchedCopy", 95.0),
        ("", "copy_kernel", 35.0),       # launched after every span closed
        ("", "orphan_kernel", 10.0),     # its launch is not in the trace
        ("", "late_kernel", 10.0),       # clipped to the window
    ])
    # idle gaps (busy 360 of 1000 us): [0, 20] ulcx.encode, [40, 100]
    # transform, [150, 260] and [300, 440] analysis, [540, 705]
    # size_round (the second), [800, 850] bitstream, [860, 955] none
    assert got.spans == {
        "ulcx.encode": {"count": 1, "host_us": 890.0, "host_self_us": 30.0, "idle_us": 20.0},
        "ulcx.encode.analysis": {"count": 1, "host_us": 380.0, "host_self_us": 210.0, "idle_us": 250.0},
        "ulcx.encode.analysis.transform": {"count": 1, "host_us": 170.0, "host_self_us": 170.0,
                                           "idle_us": 60.0},
        "ulcx.encode.bitstream": {"count": 1, "host_us": 480.0, "host_self_us": 220.0, "idle_us": 50.0},
        "ulcx.encode.bitstream.size_round": {"count": 2, "host_us": 260.0, "host_self_us": 260.0,
                                             "idle_us": 165.0},
        "ulcx.decode": {"count": 1, "host_us": 20.0, "host_self_us": 20.0, "idle_us": 0.0},
        "": {"count": 0, "host_us": 0.0, "host_self_us": 0.0, "idle_us": 95.0},
    }
    assert spans.coverage(got.attributed) == pytest.approx(305 / 360)
    assert spans.layer_metric("analysis_ms_per_step.encode", got.attributed, 2, "encode") == 0.045
    assert spans.layer_metric("bitstream_glue_ms_per_step.encode", got.attributed, 1, "encode") == 0.095
    assert spans.layer_metric("tokens_ms_per_block.decode", got.attributed, 1, "encode") is None


def test_decode_layer_times():
    ev = [X(trace.WINDOW, "user_annotation", 0, 100), X("ulcx.decode", "user_annotation", 1, 98),
          X("ulcx.decode.tokens", "user_annotation", 2, 10),
          X("ulcx.decode.imdct", "user_annotation", 50, 40),
          X("cudaLaunchKernel", "cuda_runtime", 3, 1, corr=1), X("gather_kernel", "kernel", 5, 4, corr=1),
          X("cudaLaunchKernel", "cuda_runtime", 8, 1, corr=2), X("nybbles", "kernel", 9, 6, corr=2),
          X("cudaLaunchKernel", "cuda_runtime", 55, 1, corr=3), X(GEMM, "kernel", 56, 20, corr=3),
          X("cudaLaunchKernel", "cuda_runtime", 60, 1, corr=4), X("lap_kernel", "kernel", 76, 3, corr=4),
          X("cudaLaunchKernel", "cuda_runtime", 95, 1, corr=5), X("stack", "kernel", 96, 2, corr=5)]
    att = spans.attribute(ev).attributed
    assert spans.layer_metric("tokens_ms_per_block.decode", att, 2, "decode") == 0.005
    assert spans.layer_metric("imdct_ms_per_block.decode", att, 1, "decode") == 0.023
    assert spans.layer_metric("imdct_ms_per_block.decode", att, 1, "encode") is None
    assert spans.device_us(att, "ulcx.decode") == 35.0


@pytest.mark.parametrize("params", [
    {"path": "encode", "streams": 8192, "positions": 4096},
    {"path": "decode", "streams": 8192, "positions": 4096, "window_bytes": 832},
])
def test_existing_readers_read_the_same_with_spans(params):
    bare = trace.reduce(_encode_trace(False), 2, params)
    spanned = trace.reduce(_encode_trace(True), 2, params)
    for f in ("kernels", "busy_us", "window_us", "steps", "params", "device_ops"):
        assert getattr(spanned, f) == getattr(bare, f), f
    # a gap under a host operation keeps its name; one under none now has the span's
    assert sum(s for _, s in spanned.idle_gaps) == sum(s for _, s in bare.idle_gaps)

    def named(gaps):
        return {k: v for k, v in gaps if k != "host, outside any operation" and not k.startswith("ulcx.")}

    assert named(bare.idle_gaps) == named(spanned.idle_gaps) == {"aten::mm": 50e-6}
    bench = spec.load_benchmark()
    for m in bench["per_layer"]:
        read = spec.reader(m["name"])
        assert read(spanned) == read(bare), m["name"]


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return copy_benchmark(tmp_path_factory.mktemp("bench"))


def test_devtool_tables_the_spans_of_a_traced_run(small, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    got = torch_spans.traced_run("bs2048.encode_b8192", 2**31 + 7, 1.0, device=torch.device("cpu"),
                                 root=small)
    assert got["rc"] == 0 and got["correct"] is True
    names = set(got["spans"])
    assert {"ulcx.encode", "ulcx.encode.analysis", "ulcx.encode.bitstream.size_round"} <= names
    assert got["spans"]["ulcx.encode.bitstream.size_round"]["count"] == 2  # a step's seeded ladder
    assert (tmp_path / "chiprun_out" / "spans" / f"bs2048.encode_b8192.{2**31 + 7}.json").is_file()


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the spans' share of device time is a card's")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["bs2048.encode_b8192", "bs32768.encode_b256", "bs2048.decode_b8192"])
def test_spans_launch_the_device_time(card, small, cell, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    got = torch_spans.traced_run(cell, 2**31 + 9, 1.0, device=card, root=small)
    assert got["rc"] == 0 and got["correct"] is True
    assert got["coverage"] >= 0.97, got["spans"].get("")
