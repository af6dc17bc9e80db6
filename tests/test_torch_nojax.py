"""The port runs where JAX is not installed.

A fresh interpreter makes ``import jax`` and ``import ulcx`` fail, imports every module of
``ulcx_torch``, encodes a tiny batch on the CPU and decodes it again.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
sys.modules["ulcx"] = None  # and so does any import of the JAX package
import numpy as np, torch
import ulcx_torch
for mod in pkgutil.walk_packages(ulcx_torch.__path__, "ulcx_torch."):
    __import__(mod.name)
from ulcx_torch.parallel.mesh import batch_decode, batch_encode
from ulcx_torch.utils.config import CodecConfig
cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=256)
x = np.random.default_rng(0).standard_normal((2, 2, 2, 256)).astype(np.float32) * 0.3
out, stats = batch_encode(x, cfg, "cbr", rate_kbps=128.0, device="cpu")
assert out.data.shape == (2, 2, 1024) and (out.size_bits > 0).all()
streams = torch.zeros(2, 3 * 1024 + 64, dtype=torch.uint8)
for i in range(2):
    nb = (out.size_bits[i] // 8).tolist()
    streams[i, : sum(nb)] = torch.cat([out.data[i, j, : nb[j]] for j in range(2)])
pcm, bits, corrupt = batch_decode(streams, 2, 1024, cfg, device="cpu")
assert pcm.shape == (2, 2, 2, 256) and not corrupt.any()
assert torch.equal((bits + 7) // 8 * 8, out.size_bits)
assert sys.modules["jax"] is None and sys.modules["ulcx"] is None
print("ok", int(stats["total_bits"]))
"""


def test_port_imports_and_encodes_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok ")
