"""The control on the card at a size a test run holds: each cell's
traffic cut to the CPU tests' size, run through the harness on CUDA with
the GEMMs in float32 (correct) and in TF32 (not correct). Needs a card:

    python -m pytest -m cuda benchmarks/tests/test_bench_card.py
"""

from __future__ import annotations

import contextlib
import io
import json

import pytest
import torch
from bench_helpers import copy_benchmark

CELLS = ["bs2048.encode_b8192", "bs32768.encode_b256", "bs2048.decode_b8192"]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the control runs on the card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return copy_benchmark(tmp_path_factory.mktemp("bench"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("tf32", [False, True])
def test_control_on_the_card(card, small, cell, tf32):
    from benchmarks import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = run.main(["--workload", cell, "--seed", "2147483777", "--seconds", "1", "--trace", "0"],
                      device=card, root=small, tf32=tf32)
    assert rc == 0
    assert json.loads(out.getvalue().splitlines()[-1])["correct"] is (not tf32)
