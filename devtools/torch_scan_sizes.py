#!/usr/bin/env python3
"""Total coded bits of the multichannel shapes that take ulcx's scan path, for one tree of the port.

    python3 devtools/torch_scan_sizes.py [ROOT [DEVICE]]   # DEVICE cpu (default) or cuda

Imports ``ulcx_torch`` from ROOT (default: this repo), so a parent
unpacked with ``git archive`` and this tree can be compared. Encodes the
shapes of ``tests/test_torch_scan_path.py``'s multichannel test (c / 2
stereo ``bench.make_corpus`` streams side by side per stream; 8 and 16
channels x bs256 at CBR-32 with B=2, T=2; 16 channels x bs2048 at
CBR-128 with B=1, T=2) with ``batch_encode`` and prints one JSON line
per shape: the block sizes and their total. The test holds the totals
within 1 % of ulcx's. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {  # name: (channels, block size, CBR kbps, B, T)
    "8ch_bs256_cbr32": (8, 256, 32.0, 2, 2),
    "16ch_bs256_cbr32": (16, 256, 32.0, 2, 2),
    "16ch_bs2048_cbr128": (16, 2048, 128.0, 1, 2),
}


def main(root: str, device: str) -> int:
    sys.modules["jax"] = None
    sys.modules["ulcx"] = None
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from bench import make_corpus
    from ulcx_torch.parallel.mesh import batch_encode
    from ulcx_torch.utils.config import CodecConfig

    torch.set_num_threads(1)
    for name, (c, n, kbps, b, t) in SHAPES.items():
        s = make_corpus(b * c // 2, t, n)
        x = s.reshape(b, c // 2, t, 2, n).transpose(0, 2, 1, 3, 4).reshape(b, t, c, n).copy()
        cfg = CodecConfig(rate_hz=44100, n_chan=c, block_size=n)
        out, _ = batch_encode(torch.from_numpy(x), cfg, "cbr", device=device, rate_kbps=kbps)
        sizes = out.size_bits.cpu()
        print(json.dumps({"root": os.path.abspath(root), "shape": name, "device": device,
                          "size_bits": sizes.tolist(), "total_bits": int(sizes.sum())}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else HERE,
                  sys.argv[2] if len(sys.argv) > 2 else "cpu"))
