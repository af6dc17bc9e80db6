"""BENCHMARK.json against the benchmark's contract, and the parts it
names found by name, also in a copy of the folder with a part added."""

from __future__ import annotations

import json
import re

import pytest
from bench_helpers import REPO, copy_benchmark

from benchmarks import spec

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["paths"] == ["benchmarks"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reported = [m for m in BENCH["end_to_end"] if spec.applies(m, w["name"])]
        assert len(reported) >= 2
        layer = spec.per_layer_for(BENCH, w["name"])
        assert layer and all(m["moves"] in {r["name"] for r in reported} for m in layer)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


def test_every_named_part_loads():
    for c in BENCH["configs"]:
        conf = spec.config(c["name"])
        assert c["file"] == f"benchmarks/configs/{c['name']}.json" and c["reduced"] == []
        assert set(conf["codec"]) == {"rate_hz", "n_chan", "block_size"}
    for w in BENCH["workloads"]:
        traffic = spec.traffic(w["traffic"])
        assert callable(spec.kind(traffic["kind"]).run)
        assert set(spec.limits(w["name"])) >= {"set_from"}
    for m in BENCH["per_layer"]:
        assert spec.reader(m["name"])(None) is None  # nothing to read: nothing returned


def test_a_new_part_is_found_by_name_without_an_edit(tmp_path):
    root = copy_benchmark(tmp_path, small=False)
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "configs" / "mono44k_cbr96_bs2048.json").write_text(json.dumps(
        {"codec": {"rate_hz": 44100, "n_chan": 1, "block_size": 2048}, "mode": "cbr", "rate_kbps": 96,
         "budget_bits": 4458, "reduced": []}))
    (root / "traffic" / "encode_b512.json").write_text(json.dumps(
        dict(spec.traffic("encode_b8192"), streams=512)))
    (root / "limits" / "mono_bs2048.encode_b512.json").write_text(json.dumps({"set_from": "test"}))
    (root / "metrics" / "host_ms_per_step.py").write_text(
        "def read(view):\n    return None if view is None else 1.0\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "mono44k_cbr96_bs2048", "source": "x", "reduced": [],
                             "file": "benchmarks/configs/mono44k_cbr96_bs2048.json", "why": "x"})
    bench["workloads"].append({"name": "mono_bs2048.encode_b512", "config": "mono44k_cbr96_bs2048",
                               "traffic": "encode_b512", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "host_ms_per_step", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "x", "moves": "encode_rtf"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    loaded = spec.load_benchmark(root)
    cell = spec.cell(loaded, "mono_bs2048.encode_b512")
    assert spec.config(cell["config"], root)["rate_kbps"] == 96
    assert spec.traffic(cell["traffic"], root)["streams"] == 512
    assert spec.limits(cell["name"], root) == {"set_from": "test"}
    assert spec.reader("host_ms_per_step", root)(object()) == 1.0
    # a metric without a list of cells goes to every cell reporting what it moves
    assert "host_ms_per_step" in [m["name"] for m in spec.per_layer_for(loaded, "bs2048.encode_b8192")]
    assert "host_ms_per_step" not in [m["name"] for m in spec.per_layer_for(loaded, "bs2048.decode_b8192")]
    after = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())


def test_an_unknown_part_is_refused():
    with pytest.raises(FileNotFoundError):
        spec.traffic("no_such_traffic")
    with pytest.raises(KeyError):
        spec.cell(BENCH, "no.such_cell")
