"""Build, load and launch the port's CUDA kernels.

``csrc/encode_walks.cu`` and ``csrc/decode_walks.cu`` have a plain C
interface, so one ``nvcc`` call compiles both into one shared library,
loaded with ctypes: no PyTorch headers, a build of seconds. Both include
``csrc/walk_ring.cuh``. The library goes to ``build/ulcx_torch/`` beside
the package, named by a hash of every file under ``csrc/`` and the
flags, so a changed source or header is rebuilt at its first use and an
unchanged one is loaded as it is. Nothing is built when the module is
imported.

``on_cpu``, ``check`` and ``launch`` are the wrappers' common steps: a
wrapper runs its plain version on CPU tensors, and on CUDA tensors
checks its arguments and launches its kernel.
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

from ulcx_torch.utils.profiling import span

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "encode_walks.cu", _CSRC / "decode_walks.cu")
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
    "ulcx_p1": (6, 5),
    "ulcx_p2": (7, 5),
    "ulcx_p3_size": (4, 5),
    "ulcx_p3_materialize": (11, 6),
    "ulcx_fsm": (8, 8),
    "ulcx_fsm_place": (7, 8),
    "ulcx_rng_expand": (4, 6),
    "ulcx_rng": (4, 6),
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
    """Compile the kernels if these sources have no library yet. Returns
    (library path, seconds spent compiling; 0 when already built)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):  # the sources and the headers they include
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    out = BUILD_DIR / f"libulcx_walks_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp), *map(str, SOURCES)],
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
    with span("ulcx.build.library"):
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, (n_ptr, n_int) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        return lib


def on_cpu(*tensors) -> bool:
    """True when every input lies on the CPU; False when all lie on one
    CUDA device; anything else raises."""
    devs = {x.device for x in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")
    (dev,) = devs
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def check(name: str, x, dtype, shape) -> None:
    """Raise unless ``x`` has this dtype and shape and is contiguous."""
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def launch(fn_name: str, tensors, ints, device) -> None:
    """Call entry point ``fn_name`` on the current stream of ``device``
    with the tensors' pointers, then the ints; raise on a CUDA error."""
    import torch

    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*(x.data_ptr() for x in tensors), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: kernel launch failed with CUDA error {rc}")
