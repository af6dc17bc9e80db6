"""ulcx_torch — the ulcx codec ported to PyTorch and CUDA.

A second implementation of the ``ulcx`` package for one NVIDIA Hopper
GPU. ``ulcx`` (JAX/Pallas) stays the reference; each module here
mirrors the module of the same name there and is tested against it.

This slice is the batched encode path: ``parallel.mesh.batch_encode``
-> ``codec.encoder.encode_stream_batched`` -> per-block analysis ->
``bitstream.fast_encode`` rate search and materialization, whose four
serial walks are CUDA C++ kernels (``csrc/encode_walks.cu``). Every
function follows the device of its input tensors: on the CPU the walks
run their plain PyTorch versions, on a CUDA device the kernels.

Nothing here imports jax; the one ``ulcx`` module reused is the
jax-free ``ulcx.utils.config``.
"""

__version__ = "0.1.0"

from ulcx_torch.utils.config import CodecConfig  # noqa: F401
