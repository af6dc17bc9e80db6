"""Build and load the port's CUDA kernels.

``csrc/encode_walks.cu`` has a plain C interface, so it is compiled by
``nvcc`` alone into a shared library and loaded with ctypes: no PyTorch
headers, a build of seconds. The library goes to ``build/ulcx_torch/``
beside the package, named by a hash of the source and flags, so a
changed source is rebuilt at its first use and an unchanged one is
loaded as it is. Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from functools import lru_cache
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "encode_walks.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "ulcx_torch"
# No --use_fast_math: the walks need the accurate logf and sqrtf, with
# denormals kept.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# entry point -> (pointer arguments, int arguments); each also takes the
# stream last and returns cudaGetLastError() as an int
_SIGNATURES = {
    "ulcx_p1": (6, 2),
    "ulcx_p2": (7, 2),
    "ulcx_p3_size": (4, 2),
    "ulcx_p3_materialize": (11, 3),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return path


def build() -> tuple[Path, float]:
    """Compile the kernels if this source has no library yet. Returns
    (library path, seconds spent compiling; 0 when already built)."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libencode_walks_{digest}.so"
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, out)
    # ptxas -v: registers, shared memory and spills of each kernel
    out.with_suffix(".ptxas.txt").write_text(proc.stderr)
    return out, time.perf_counter() - t0


@lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (n_ptr, n_int) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
