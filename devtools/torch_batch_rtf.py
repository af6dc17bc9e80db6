#!/usr/bin/env python3
"""Aggregate realtime factor of the batch tool, for one tree of the port, on one card.

    python3 devtools/torch_batch_rtf.py [ROOT [RUNS]]   # one CUDA GPU

Imports ``ulcx_torch`` from ROOT (default: this repo), so one call can
alternate processes of two trees (a parent unpacked into an ignored
directory, then this one). Writes ``chip_smoke.py`` phase 16's WAVs
(30 s stereo PCM16 of ``bench.make_corpus``, CBR-128, bs2048) and runs
``ulcx_torch.tools.batch_tool.main`` in process over 4 of them (a batch
that is no multiple of 8) and over 8, once to warm up and then RUNS
times (3 by default). Prints the card's name and power limit, then one
JSON line per file count: the walk launches of a run, the seconds of
each timed run (each from the call to its return: reading, encoding on
the card and writing the files) and the aggregate realtime factor at
their median. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECONDS, BS = 30, 2048
FILE_COUNTS = (4, 8)


def main(root: str, runs: int) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_batch_rtf: no CUDA device", file=sys.stderr)
        return 1
    sys.modules["jax"] = None
    sys.modules["ulcx"] = None
    sys.path.insert(0, os.path.abspath(root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from bench import make_corpus
    from ulcx_torch._build import launch_counts, reset_launch_counts
    from ulcx_torch.io.wavio import WavWriter
    from ulcx_torch.tools.batch_tool import main as batch_main

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    t = -(-SECONDS * 44100 // BS)
    corpus = make_corpus(max(FILE_COUNTS), t, BS)  # [F, T, 2, N]
    tmp = tempfile.mkdtemp(prefix="ulcx_batch_rtf_")
    try:
        wavs = []
        for i, blocks in enumerate(corpus):
            wavs.append(os.path.join(tmp, f"in{i}.wav"))
            w = WavWriter(wavs[-1], 44100, 2, 16, 1)
            w.write_frames(blocks.transpose(0, 2, 1).reshape(-1))
            w.close()
        audio_s = t * BS / 44100
        for files in FILE_COUNTS:
            argv = ["b", os.path.join(tmp, f"out{files}"), "128", *wavs[:files], f"-blocksize:{BS}"]
            secs = []
            for run in range(runs + 1):
                reset_launch_counts()
                log = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(log):
                    rc = batch_main(argv, device="cuda")
                dt = time.perf_counter() - t0
                if rc != 0 or f"Encoded {files} files." not in log.getvalue():
                    raise AssertionError(f"batch_tool over {files} files: exit {rc}\n"
                                         f"{log.getvalue()[-2000:]}")
                if run:
                    secs.append(dt)
            med = sorted(secs)[len(secs) // 2]
            print(json.dumps({"root": os.path.abspath(root), "files": files, "card": card,
                              "launches": launch_counts(), "seconds": secs,
                              "rtf_median": files * audio_s / med}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else HERE,
                  int(sys.argv[2]) if len(sys.argv) > 2 else 3))
