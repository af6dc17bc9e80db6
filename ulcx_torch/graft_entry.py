"""Driver entry points of the port: one encode block step, and the
data-parallel dry run over a process group.

Counterpart of the repo's ``__graft_entry__.py``. ``entry`` is one
batched CBR-128 encode block step on the card; ``dryrun_multichip(n)``
launches ``n`` ranks under ``torchrun`` and runs ulcx's two dry-run
phases over the mesh of ``parallel.mesh``.

The rank code lives here, because ``torchrun`` starts each rank by
importing this module:

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m ulcx_torch.graft_entry dryrun 2 cpu

runs the dry run on two CPU ranks over gloo, and

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        -m ulcx_torch.graft_entry mesh IN.npz OUT_DIR DEVICE_TYPE RUNS

encodes the global batch ``x`` [B, T, C, N] of ``IN.npz`` at CBR-128
over the mesh (counting its kernel launches), beside the no-mesh call
on the rank's rows, checks the refusals, decodes the result (and
``streams`` of ``IN.npz``, where it holds them), times ``RUNS`` encodes
and decodes, and writes each rank's shard to ``OUT_DIR/rank<r>.npz``.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ulcx_torch._build import launch_counts, reset_launch_counts
from ulcx_torch.bitstream.decode_kernels import Walks as DecodeWalks
from ulcx_torch.bitstream.encode_kernels import Walks as EncodeWalks
from ulcx_torch.codec.encoder import (
    encode_block_batched,
    init_carry_batched,
    max_block_bytes,
)
from ulcx_torch.parallel.mesh import batch_decode, batch_encode, data_mesh, shard_rows
from ulcx_torch.utils.config import CodecConfig
from ulcx_torch.utils.device import on_device

RATE_KBPS = 128.0
SHARD_STREAMS = 8  # phase 2's streams a rank; ulcx takes 128 for its lane layout
_ROOT = Path(__file__).resolve().parent.parent


def entry(device="cuda"):
    """(fn, example_args): one batched CBR-128 encode block step on the
    flagship path (analysis, the walks' rate search, packing) at stereo
    bs1024, B = 8. ``fn(carry, blocks)`` returns (data, size_bits,
    carry). A plain callable: the walks are ctypes launches, so it is
    not compiled."""
    cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=1024)

    def fn(carry, blocks):
        carry, enc = encode_block_batched(carry, blocks, cfg, "cbr", rate_kbps=RATE_KBPS)
        return enc.data, enc.size_bits, carry

    blocks = on_device(
        np.random.default_rng(0).standard_normal((8, 2, 1024)).astype(np.float32) * 0.3, device)
    return fn, (init_carry_batched(cfg, 8, blocks.device), blocks)


def rank_devices(n: int, device_type: str):
    """Every rank's device for ``n`` ranks: ``None`` (a card each,
    ``data_mesh``'s default) when ``n`` cards are visible, else the
    cards in turn, ranks sharing them; on the CPU ``"cpu"`` each."""
    if device_type == "cpu":
        return ["cpu"] * n
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device")
    return None if n <= count else [f"cuda:{i % count}" for i in range(n)]


def launch(n: int, args, timeout: float) -> str:
    """Run ``n`` ranks of this module with ``args`` under ``torchrun
    --standalone`` (a free local port); return their standard output.
    A rank that fails, or a run past ``timeout`` seconds, raises; every
    process started is stopped."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n), "-m", "ulcx_torch.graft_entry", *map(str, args)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(_ROOT), env.get("PYTHONPATH")]))
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:  # timed out: stop torchrun and its ranks
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} exited with code {proc.returncode}:\n"
                           f"{out[-4000:]}\n{err[-8000:]}")
    return out


def _gather(mesh, x: np.ndarray) -> np.ndarray:
    """Every rank's array, concatenated in rank order (row order). The
    gathers go through the host: gloo has no all_gather of CUDA tensors."""
    parts = [None] * mesh.world_size
    dist.all_gather_object(parts, x, group=mesh.group)
    return np.concatenate(parts)


def gather_blocks(mesh, out):
    """Every rank's encoded blocks [b, T] in row order: (size_bits
    [B, T], data [B, T, M]) as numpy, M the largest block's bytes."""
    sizes = _gather(mesh, out.size_bits.cpu().numpy())
    return sizes, _gather(mesh, out.data[..., : int(sizes.max()) // 8].cpu().numpy())


def bench_window(sizes) -> int:
    """A decode window as ``bench.py`` sizes it: the largest block's
    bytes rounded up to 64, plus 64."""
    return -(-int(sizes.max() // 8) // 64) * 64 + 64


def pack_streams(sizes, data, win: int) -> np.ndarray:
    """Blocks [B, T] -> padded byte streams [B, T * win + win + 64], each
    block's bytes after the last (``__graft_entry__.py:72-81``)."""
    b, t = sizes.shape
    streams = np.zeros((b, t * win + win + 64), np.uint8)
    for i in range(b):
        off = 0
        for j in range(t):
            nb = int(sizes[i, j]) // 8
            streams[i, off: off + nb] = data[i, j, :nb]
            off += nb
    return streams


def _check_decode(label, sizes, bits, corrupt):
    if bool(corrupt.any()):
        raise AssertionError(f"{label}: {int(corrupt.sum())} blocks decode as corrupt")
    if not np.array_equal((bits.cpu().numpy() + 7) & ~7, sizes):
        raise AssertionError(f"{label}: decoded bits, rounded up to bytes, differ from the sizes")


def _dryrun_rank(n: int, device_type: str) -> None:
    """One rank of ``dryrun_multichip``: ulcx's two phases."""
    mesh = data_mesh(rank_devices(n, device_type))
    try:
        dev, rng = mesh.device, np.random.default_rng(1)
        # phase 1: stereo bs256, a stream a rank, two blocks
        cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=256)
        b, t = n, 2
        blocks = rng.standard_normal((b, t, 2, 256)).astype(np.float32) * 0.3
        out, stats = batch_encode(blocks, cfg, "cbr", mesh=mesh, device=dev, rate_kbps=RATE_KBPS)
        if not float(stats["total_bits"]) > 0:
            raise AssertionError(f"total bits {float(stats['total_bits'])}")
        sizes, data = gather_blocks(mesh, out)
        win = max_block_bytes(cfg)
        _, bits, corrupt = batch_decode(pack_streams(sizes, data, win), t, win, cfg, mesh=mesh,
                                        device=dev)
        _check_decode("phase 1", sizes[shard_rows(b, mesh)], bits, corrupt)
        backend = dist.get_backend(mesh.group)
        if mesh.rank == 0:
            print(f"dryrun_multichip({n}): ok — {float(stats['total_bits']):.0f} bits, decode "
                  f"clean (bs256, {backend} over {n} ranks)", flush=True)

        # phase 2: stereo bs2048 (P = 4096), one block, the walks on the
        # card's kernels (their plain versions on the CPU)
        kcfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=2048, use_pallas="on")
        kb = SHARD_STREAMS * n
        kblocks = rng.standard_normal((kb, 1, 2, 2048)).astype(np.float32) * 0.3
        kout, kstats = batch_encode(kblocks, kcfg, "cbr", mesh=mesh, device=dev,
                                    rate_kbps=RATE_KBPS)
        ksizes, kdata = gather_blocks(mesh, kout)
        if not (ksizes > 0).all():
            raise AssertionError("an empty block")
        # the window from the largest block (the ULC2 header's contract)
        kwin = int(((ksizes.max() // 8) + 8 + 3) // 4 * 4)
        _, kbits, kcor = batch_decode(pack_streams(ksizes, kdata, kwin), 1, kwin, kcfg,
                                      mesh=mesh, device=dev)
        _check_decode("phase 2", ksizes[shard_rows(kb, mesh)], kbits, kcor)
        if mesh.rank == 0:
            walks = "kernels" if dev.type == "cuda" else "plain versions"
            print(f"dryrun_multichip({n}): ok — encode walks and decode ({walks}) over the mesh "
                  f"at stereo bs2048, {SHARD_STREAMS} streams a rank, "
                  f"{float(kstats['total_bits']):.0f} bits, decode clean", flush=True)
    finally:
        mesh.close()


def dryrun_multichip(n_devices: int, device_type: str = "cuda") -> None:
    """Run one batched encode and decode over an ``n_devices``-rank mesh
    on tiny shapes, as ``__graft_entry__.dryrun_multichip`` does: phase 1
    at stereo bs256 (a stream a rank, two blocks), phase 2 at stereo
    bs2048 (P = 4096, one block) through the encode walks and decode
    kernels. Phase 2 takes 8 streams a rank, not ulcx's 128: ulcx needs
    128 for its lane layout, the port's walks take any batch.

    Outside a ``torchrun`` world it launches ``n_devices`` ranks of
    itself under ``torchrun`` (``launch``) and raises if one fails;
    inside one it is a rank. On ``device_type="cuda"`` each rank takes a
    card of its own over NCCL when there are enough, else ranks share
    the cards over gloo (``rank_devices``)."""
    if "WORLD_SIZE" in os.environ:
        _dryrun_rank(n_devices, device_type)
    else:
        print(launch(n_devices, ["dryrun", n_devices, device_type], timeout=600), end="",
              flush=True)


def _timed(mesh, fn, runs: int) -> list:
    """Wall seconds of ``runs`` calls of ``fn``, each from a barrier
    before it to a barrier after it (so the slowest rank's wall)."""
    walls = []
    for _ in range(runs):
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        dist.barrier(group=mesh.group)
        t0 = time.perf_counter()
        fn()
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        dist.barrier(group=mesh.group)
        walls.append(time.perf_counter() - t0)
    return walls


def _refusal(fn) -> str:
    """The ValueError that ``fn`` raises, as text; '' when it raises none."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _mesh_rank(inp: str, out_dir: str, device_type: str, runs: int) -> None:
    """One rank of the mesh run (module docstring)."""
    mesh = data_mesh(rank_devices(int(os.environ.get("WORLD_SIZE", 1)), device_type))
    try:
        f = np.load(inp)
        x = f["x"]
        dev, (b, t) = mesh.device, x.shape[:2]
        cfg = CodecConfig(rate_hz=44100, n_chan=x.shape[2], block_size=x.shape[3])
        rows = shard_rows(b, mesh)

        def encode(xs, **kw):
            return batch_encode(xs, cfg, "cbr", mesh=mesh, device=dev, rate_kbps=RATE_KBPS, **kw)

        reset_launch_counts()
        out, stats = encode(x)
        enc_launches = launch_counts(*EncodeWalks._fields)
        major, _ = encode(x, scan_major=True)
        alone, _ = batch_encode(x[rows], cfg, "cbr", device=dev, rate_kbps=RATE_KBPS)
        sizes, data = gather_blocks(mesh, out)
        win = bench_window(sizes)
        streams = pack_streams(sizes, data, win)
        reset_launch_counts()
        pcm, bits, corrupt = batch_decode(streams, t, win, cfg, mesh=mesh, device=dev)
        res = {
            "launches": np.array(json.dumps({**enc_launches, **launch_counts(*DecodeWalks._fields)})),
            "rows": np.array([rows.start, rows.stop]),
            **{k: v.cpu().numpy() for k, v in out._asdict().items()},
            "major_shape": np.array(major.size_bits.shape),
            "major_same": np.array(all(torch.equal(u, v.transpose(0, 1))
                                       for u, v in zip(out, major))),
            **{f"alone_{k}": v.cpu().numpy() for k, v in alone._asdict().items()},
            "total_bits": stats["total_bits"].cpu().numpy(),
            "avg_complexity": stats["avg_complexity"].cpu().numpy(),
            "win": np.array(win),
            "pcm": pcm.cpu().numpy(), "bits": bits.cpu().numpy(),
            "corrupt": corrupt.cpu().numpy(),
            "refuse_split": np.array(_refusal(lambda: encode(x[: b - 1]))),
            "refuse_device": np.array(_refusal(lambda: batch_encode(
                x, cfg, "cbr", mesh=mesh, device="cuda" if dev.type == "cpu" else "cpu",
                rate_kbps=RATE_KBPS))),
            "backend": np.array(dist.get_backend(mesh.group)),
            "device": np.array(str(dev)),
        }

        if "streams" in f:  # streams given: decode them over the mesh too
            g = batch_decode(f["streams"], int(f["n_blocks"]), int(f["window"]), cfg, mesh=mesh,
                             device=dev)
            res.update(zip(("given_pcm", "given_bits", "given_corrupt"),
                           (y.cpu().numpy() for y in g)))
        res["encode_s"] = np.array(_timed(mesh, lambda: encode(x), runs))
        res["decode_s"] = np.array(_timed(
            mesh, lambda: batch_decode(streams, t, win, cfg, mesh=mesh, device=dev), runs))
        np.savez(Path(out_dir) / f"rank{mesh.rank}.npz", **res)
    finally:
        mesh.close()


def main(argv) -> int:
    if argv[0] == "dryrun":
        dryrun_multichip(int(argv[1]), argv[2])
    elif argv[0] == "mesh":
        _mesh_rank(argv[1], argv[2], argv[3], int(argv[4]))
    else:
        raise SystemExit(f"usage: graft_entry dryrun N DEVICE_TYPE | "
                         f"mesh IN.npz OUT_DIR DEVICE_TYPE RUNS (got {argv})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
