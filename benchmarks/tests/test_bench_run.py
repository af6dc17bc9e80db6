"""The harness's result line, its import guard and its refusals, driven
on the CPU at a small size (the look for a card skipped)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
from bench_helpers import REPO, copy_benchmark, run_cpu

from benchmarks import run, spec

KEYS = {"correct", "attempted", "failed", "metrics", "device", "compared"}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return copy_benchmark(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["bs2048.encode_b8192", "bs32768.encode_b256",
                                  "bs2048.decode_b8192"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(small, cell, trace):
    rc, out, err = run_cpu(small, cell, trace=trace)
    assert rc == 0, err
    res = json.loads(out[-1])
    assert set(res) == KEYS | ({"breakdown"} if trace else set())
    assert list(res)[-1] == "compared" and res["correct"] is True, err
    assert res["attempted"] >= 1 and res["failed"] == 0
    bench = spec.load_benchmark(small)
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        # on the CPU no operation runs on a device: the device readers read nothing
        assert set(res["metrics"]) <= {m["name"] for m in spec.per_layer_for(bench, cell)}
    else:
        assert set(res["metrics"]) == {m["name"] for m in bench["end_to_end"] if spec.applies(m, cell)}
        assert all(v["value"] > 0 for v in res["metrics"].values())
    lines = [x for x in err.splitlines() if x.startswith("compared ")]
    assert len(lines) == len(res["compared"]) and err.rstrip().endswith(lines[-1])


def test_same_seed_same_answers(small):
    outs = [json.loads(run_cpu(small, "bs2048.encode_b8192", seed=7)[1][-1])["compared"] for _ in range(2)]
    assert outs[0] == outs[1]


def test_import_guard_names_whole_top_level_names(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ulcx_torch_like", object())
    assert "ulcx_torch_like" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ulcx.codec", object())
    assert "ulcx" in run.forbidden_modules()


def test_a_run_loads_no_jax():
    """A run's imports (the harness, every kind, reference and reader, the
    port) leave no module named jax, jaxlib, flax or ulcx."""
    code = ("import sys\n"
            "from benchmarks import run, spec\n"
            "b = spec.load_benchmark()\n"
            "[spec.kind(spec.traffic(w['traffic'])['kind']) for w in b['workloads']]\n"
            "[spec.reader(m['name']) for m in b['per_layer']]\n"
            "import benchmarks.reference.checks, benchmarks.bitgen, benchmarks.corpus, benchmarks.trace\n"
            "import ulcx_torch.codec.encoder, ulcx_torch.parallel.mesh\n"
            "sys.exit(len(run.forbidden_modules()))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    assert subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env).returncode == 0


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, "-m", "benchmarks.run", "--workload", "bs2048.encode_b8192",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True,
                          text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and proc.stdout == "" and "CUDA device" in proc.stderr


def test_without_the_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmarks/, the
    run fails and prints no result (here also with no look for a card)."""
    copy_benchmark(tmp_path)
    code = ("import sys, torch\nfrom benchmarks import run\n"
            "sys.exit(run.main(['--workload', 'bs2048.encode_b8192', '--seed', '1', '--seconds', '1',"
            " '--trace', '0'], device=torch.device('cpu')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert proc.returncode != 0 and proc.stdout == ""
    assert "ulcx_torch" in proc.stderr
