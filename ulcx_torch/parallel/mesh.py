"""Data-parallel batch execution over GPUs.

Port of ``ulcx.parallel.mesh``. Streams are independent, so the stream
batch is the one distribution axis: every rank codes a contiguous shard
of the batch through the same block pipeline, and no codec state
crosses ranks. The only collective is one all-reduce of the two
metrics of ``batch_encode``.

Where ulcx's ``shard_map`` runs one process over a mesh of devices,
PyTorch's idiom is one process per device: a ``torch.distributed``
process group, usually launched by ``torchrun``
(``python -m torch.distributed.run --nproc-per-node N``), and a
``DeviceMesh`` with one dimension named ``"data"``. Each rank passes
the global batch and gets its own shard of the outputs back.

Without a mesh, one device codes the whole batch. The entry points run
on the card unless the caller passes ``device="cpu"``; with no card,
the default raises rather than falling back to the CPU
(``utils.device.on_device``).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ulcx_torch.codec.decoder import decode_stream_batched
from ulcx_torch.codec.encoder import encode_stream_batched
from ulcx_torch.utils.config import CodecConfig
from ulcx_torch.utils.device import on_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a one-dimensional data mesh."""

    device_mesh: DeviceMesh  # shape (world_size,), mesh_dim_names (name,)
    device: torch.device     # where this rank codes its shard
    rank: int
    world_size: int

    @property
    def group(self):
        """The process group of the mesh's one dimension."""
        return self.device_mesh.get_group(0)

    def close(self) -> None:
        """End this process's process group, so that a later mesh can
        make its own."""
        dist.destroy_process_group()


def _backend(devices) -> str:
    """``nccl`` when every rank has a card of its own; ``gloo`` on the
    CPU or when ranks share a card (NCCL refuses two ranks on one GPU)."""
    if all(d.type == "cuda" for d in devices) and len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


def data_mesh(devices=None, name: str = "data") -> Mesh:
    """This rank's mesh over the world of processes.

    Under ``torchrun`` the world (rank, size, rendezvous) comes from the
    environment. Outside it the world is this one process on one device,
    where ulcx's ``data_mesh`` spans every device of its one process.

    ``devices=None`` puts each rank on ``cuda:<LOCAL_RANK>``, which must
    exist: there is no CPU fallback. Otherwise ``devices`` lists the
    device of every rank, world-size entries (``["cpu", "cpu"]``, or
    ``["cuda:0", "cuda:0"]`` for two ranks sharing a card). The process
    group's backend follows from that list (``_backend``); a group that
    already exists is used as it is."""
    distributed = "WORLD_SIZE" in os.environ
    world = int(os.environ["WORLD_SIZE"]) if distributed else 1
    rank = int(os.environ["RANK"]) if distributed else 0
    if devices is None:
        local = int(os.environ.get("LOCAL_RANK", 0))
        if not torch.cuda.is_available() or local >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} (local rank {local}) has no CUDA device of its own: "
                               f"{torch.cuda.device_count()} visible")
        device, backend = torch.device("cuda", local), "nccl"
    else:
        devices = [torch.device(d) for d in devices]
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for a world of {world} processes")
        device, backend = devices[rank], _backend(devices)
    if device.type == "cuda":
        device = torch.device("cuda", 0 if device.index is None else device.index)
        torch.cuda.set_device(device)  # before any CUDA work, the communicator's too
        torch.cuda.init()
    if not dist.is_initialized():
        if distributed:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    mesh = init_device_mesh(device.type, (world,), mesh_dim_names=(name,))
    return Mesh(mesh, device, rank, world)


def shard_rows(b: int, mesh: Mesh) -> slice:
    """The rows of a global batch of ``b`` streams that this rank codes:
    ulcx's ``P(axis)``, contiguous, ``b / world_size`` a rank."""
    n = mesh.world_size
    if b % n:
        raise ValueError(f"a batch of B={b} streams does not split over n={n} ranks")
    k = b // n
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def _mesh_device(mesh: Mesh, device) -> torch.device:
    """The mesh's device; a ``device`` argument that names another
    raises (``"cuda"`` names the current card, which ``data_mesh`` set)."""
    want = torch.device(device)
    if want.type != mesh.device.type or want.index not in (None, mesh.device.index):
        raise ValueError(f"device {want} is not this rank's mesh device {mesh.device}")
    return mesh.device


def batch_encode(blocks, cfg: CodecConfig, mode: str, mesh: Mesh | None = None,
                 scan_major: bool = False, device="cuda", **kw):
    """Encode a batch of streams: blocks [B, T, C, N] -> (EncodedBlock
    with leading [B, T] ([T, B] with scan_major=True), stats), computed
    on ``device``.

    With a mesh, ``blocks`` is the global batch on every rank (numpy or
    a CPU tensor); each rank uploads and codes its ``shard_rows`` and
    returns its shard, leading [B/n, T] ([T, B/n]: ulcx's
    ``P(None, axis)``). The stats are then ulcx's mesh form, replicated
    by one all-reduce: ``total_bits`` a float32 sum (the no-mesh path's
    is an integer), ``avg_complexity`` over all B * T blocks."""
    if mesh is None:
        out, _ = encode_stream_batched(on_device(blocks, device), cfg, mode,
                                       scan_major=scan_major, **kw)
        stats = {
            "total_bits": torch.sum(out.size_bits),
            "avg_complexity": torch.mean(out.complexity),
        }
        return out, stats

    dev = _mesh_device(mesh, device)
    rows = shard_rows(blocks.shape[0], mesh)
    out, _ = encode_stream_batched(on_device(blocks[rows], dev), cfg, mode,
                                   scan_major=scan_major, **kw)
    stats = torch.stack([torch.sum(out.size_bits).to(torch.float32), torch.sum(out.complexity)])
    dist.all_reduce(stats, group=mesh.group)
    nblk = blocks.shape[0] * blocks.shape[1]
    return out, {"total_bits": stats[0], "avg_complexity": stats[1] / nblk}


def batch_decode(streams, n_blocks: int, window_bytes: int, cfg: CodecConfig,
                 mesh: Mesh | None = None, device="cuda"):
    """Decode a batch of padded byte streams [B, S] uint8 -> (pcm
    [B, T, C, N], bits [B, T], corrupt [B, T]) with T = n_blocks,
    computed on ``device``. With a mesh, ``streams`` is the global batch
    and each rank decodes and returns its ``shard_rows`` (no collective)."""
    if mesh is not None:
        device = _mesh_device(mesh, device)
        streams = streams[shard_rows(streams.shape[0], mesh)]
    return decode_stream_batched(on_device(streams, device), n_blocks, window_bytes, cfg)
