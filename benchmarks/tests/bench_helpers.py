"""Shared pieces of the benchmark's CPU tests: a copy of the benchmark
folder whose traffic is shrunk to a size the CPU runs in seconds, and
one in-process run of the harness on the CPU (no look for a card)."""

from __future__ import annotations

import contextlib
import io
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SMALL = {
    "encode_b8192": {"streams": 8, "pool_blocks": 4, "warmup_calls": 1, "traced_calls": 1,
                     "check": {"streams": 8, "blocks": 12}},
    # a batch of no multiple of 8 takes the exact ladder, as P = 65,536 does
    "encode_b256": {"streams": 6, "pool_blocks": 4, "warmup_calls": 1, "traced_calls": 1,
                    "check": {"streams": 6, "blocks": 12}},
    "decode_b8192": {"streams": 4, "blocks_per_call": 2, "pool_batches": 2, "unique_streams": 2,
                     "warmup_calls": 1, "traced_calls": 1, "check": {"pcm_streams": 4, "pcm_calls": 2}},
}
# a small block for the large-block cell: the same code path at CPU scale
SMALL_CONFIG = {"stereo44k_cbr128_bs32768": {"codec": {"rate_hz": 44100, "n_chan": 2, "block_size": 512},
                                             "budget_bits": 1486}}
# Limits of that stand-in where the block size sets them: the exact
# ladder leaves about one coefficient's bits unused, 0.48-0.67 % of its
# 1,486-bit budget against 0.007 % of 95,108 bits (CPU readings, 7 seeds),
# and its window controls switch on 25 % of the blocks, not 91-100 %.
SMALL_LIMITS = {"bs32768.encode_b256": {"budget_shortfall": 0.02, "wc_mismatch": 0.1}}


def copy_benchmark(dest: Path, small: bool = True) -> Path:
    """``BENCHMARK.json`` and ``benchmarks/`` under ``dest``; with
    ``small`` the traffic (and the bs32768 configuration) cut to CPU size.
    Returns the copied folder."""
    root = dest / "benchmarks"
    shutil.copytree(REPO / "benchmarks", root, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    if small:
        for name, kw in SMALL.items():
            _update(root / "traffic" / f"{name}.json", kw)
        for name, kw in SMALL_CONFIG.items():
            _update(root / "configs" / f"{name}.json", kw)
        for name, kw in SMALL_LIMITS.items():
            _update(root / "limits" / f"{name}.json", kw)
    return root


def _update(path: Path, kw: dict) -> None:
    d = json.loads(path.read_text())
    d.update(kw)
    path.write_text(json.dumps(d))


def run_cpu(root: Path, cell: str, seed: int = 2**31 + 11, seconds: float = 1.0, trace: int = 0):
    """(exit code, stdout lines, stderr) of one in-process run on the CPU."""
    import torch

    from benchmarks import run

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], device=torch.device("cpu"), root=root)
    return rc, out.getvalue().splitlines(), err.getvalue()
