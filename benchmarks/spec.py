"""Find the benchmark's parts by the names ``BENCHMARK.json`` gives them.

Each part lies in a file of its own under this folder, named after it:
a configuration in ``configs/<name>.json``, a traffic mix in
``traffic/<name>.json`` (its ``kind`` names the call shape in
``kinds/<kind>.py``), a per-layer metric's reader in
``metrics/<name>.py`` and a cell's correctness limits in
``limits/<cell>.json``. A new cell, configuration, traffic mix or metric
is so a new file and a new entry, and no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_benchmark(root: Path = HERE) -> dict:
    """``BENCHMARK.json`` beside the folder ``root``."""
    return json.loads((root.parent / "BENCHMARK.json").read_text())


def _json(root: Path, sub: str, name: str) -> dict:
    path = root / sub / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {sub[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def config(name: str, root: Path = HERE) -> dict:
    return _json(root, "configs", name)


def traffic(name: str, root: Path = HERE) -> dict:
    return _json(root, "traffic", name)


def limits(cell: str, root: Path = HERE) -> dict:
    return _json(root, "limits", cell)


def _module(root: Path, sub: str, name: str):
    path = root / sub / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {sub[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"benchmarks.{sub}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str, root: Path = HERE):
    """The module that drives a traffic kind: ``run(ctx) -> Outcome``."""
    return _module(root, "kinds", name)


def metric_module(metric: str, root: Path = HERE):
    """A per-layer metric's file, with its reader and work counts."""
    return _module(root, "metrics", metric)


def reader(metric: str, root: Path = HERE):
    """A per-layer metric's ``read(view) -> float | None``."""
    return metric_module(metric, root).read


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def applies(metric: dict, cell_name: str) -> bool:
    """Whether an end-to-end metric belongs to a cell."""
    return "workloads" not in metric or cell_name in metric["workloads"]


def per_layer_for(bench: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics a cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"] if applies(m, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]
