#!/usr/bin/env python3
"""Encode time of the shapes the scan path's plan serves, for one tree of the port, on one card.

    python3 devtools/torch_scan_rtf.py [ROOT [RUNS]]   # one CUDA GPU

Imports ``ulcx_torch`` from ROOT (default: this repo), so one call can
alternate processes of two trees (a parent unpacked into an ignored
directory, then this one). Three cells, each ``batch_encode`` CBR-128 of
``bench.make_corpus`` streams with RUNS warm repeats (5 by default):

- ``p65536``: stereo bs32768, B=256, T=2 (``chip_smoke.py`` phase 13);
- ``gap``: stereo bs2048, B=512, T=8, ``noise_run_window="gap"``
  (phase 15);
- ``ch16``: 16 channels x bs2048 (P = 32768), B=13, T=2 (phase 18).

Prints the card's name and power limit, then one JSON line per cell:
the walk launches of the first run, the total bits, and every warm
run's wall seconds (each ending in a synchronise; the host's launches
set them) and the median's ms per block step. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = {  # name: (channels, block size, B, T, noise window)
    "p65536": (2, 32768, 256, 2, "segment"),
    "gap": (2, 2048, 512, 8, "gap"),
    "ch16": (16, 2048, 13, 2, "segment"),
}


def main(root: str, runs: int) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_scan_rtf: no CUDA device", file=sys.stderr)
        return 1
    sys.modules["jax"] = None
    sys.modules["ulcx"] = None
    sys.path.insert(0, os.path.abspath(root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from bench import make_corpus
    from ulcx_torch._build import launch_counts, reset_launch_counts
    from ulcx_torch.parallel.mesh import batch_encode
    from ulcx_torch.utils.config import CodecConfig

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    for name, (c, n, b, t, window) in CELLS.items():
        # c / 2 stereo corpus streams side by side per stream, as chip_smoke.py's phase 18
        s = make_corpus(b * c // 2, t, n)
        x = s.reshape(b, c // 2, t, 2, n).transpose(0, 2, 1, 3, 4).reshape(b, t, c, n).copy()
        cfg = CodecConfig(rate_hz=44100, n_chan=c, block_size=n, noise_run_window=window)
        blocks = torch.from_numpy(np.ascontiguousarray(x)).to("cuda")
        reset_launch_counts()
        out, _ = batch_encode(blocks, cfg, "cbr", rate_kbps=128.0)
        torch.cuda.synchronize()
        counts = launch_counts()
        warm = []
        for _ in range(runs):
            t0 = time.perf_counter()
            batch_encode(blocks, cfg, "cbr", rate_kbps=128.0)
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
        med = sorted(warm)[len(warm) // 2]
        print(json.dumps({"root": os.path.abspath(root), "cell": name, "card": card,
                          "shape": {"n_chan": c, "block_size": n, "B": b, "T": t,
                                    "window": window},
                          "launches": counts, "total_bits": int(out.size_bits.sum()),
                          "warm_s": warm, "ms_per_step": med / t * 1e3}), flush=True)
        del out, blocks
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else HERE,
                  int(sys.argv[2]) if len(sys.argv) > 2 else 5))
