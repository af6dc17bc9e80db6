#!/usr/bin/env python3
"""Where an encode step of the PyTorch port spends its time, on one card.

    python3 devtools/torch_profile_encode.py [VARIANT]   # from the repo root; one CUDA GPU

Flagship shape: stereo bs2048, CBR-128, B=512 streams x T=8 blocks of
``bench.make_corpus``. VARIANT is ``loop`` (the per-block loop, the
default), ``foldN`` (``fold_bitstream=N``) or ``flat``
(``flat_stream=True``); the folded variants have no per-block layers,
so they print 2 and 3 only. Prints

1. host-synchronised layers, ms per block step (median over the T steps
   of the second of two passes): analysis, prepare, planes + sort,
   ladder (the size rounds of p1/p2/p3-size), final round (p1/p2 and the
   materializing p3 plus the choice), each ending in a synchronise;
2. ms per block step of five warm, unprofiled ``batch_encode`` calls;
3. the device view of one warm ``batch_encode`` under ``torch.profiler``:
   its wall time, device busy time and share (kernels run on one stream,
   so their sum is their union), and device ms by group: the four walk
   kernels by name, float32 GEMMs, everything else;

then one JSON line with the same numbers. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, BS, RATE_KBPS = 512, 8, 2048, 128.0
WALKS = ("p1_kernel", "p2_kernel", "p3_kernel<false>", "p3_kernel<true>")


def _sync_ms(fn, *args):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def layers(cfg, blocks):
    """Per block step, host-synced ms of each layer; the same calls as
    encoder._encode_analyzed_fast and fast_encode.search_materialize_fast."""
    import torch

    from ulcx_torch.analysis.batched import analyze_block_batched
    from ulcx_torch.bitstream import fast_encode as fe
    from ulcx_torch.codec.encoder import cbr_bit_budget, init_carry_batched, max_block_bytes

    carry = init_carry_batched(cfg, blocks.shape[0], blocks.device)
    rows = []
    for j in range(blocks.shape[1]):
        (carry, blk), t_an = _sync_ms(analyze_block_batched, carry, blocks[:, j], cfg)
        fb, t_prep = _sync_ms(fe.prepare_fast, blk, cfg)
        pl, t_planes = _sync_ms(fe.make_planes, fb)
        budget = cbr_bit_budget(cfg, RATE_KBPS).to(blocks.device).expand(blk.n_nz.shape)
        budget = budget.to(torch.int32)
        (lo, hi), t_ladder = _sync_ms(
            fe._bracket_search, lambda nn: fe.round_sizes(pl, fb.n_header, nn),
            blk.n_nz.to(torch.int32), budget, fe._rounds(fb.coef.shape[1]))

        def final():
            cands = fe._final_cands(lo, hi)
            bits, words, _, _ = fe._materialize(pl, cands, max_block_bytes(cfg))
            return fe._sizes_of(bits, fb.n_header) <= budget[:, None]

        _, t_final = _sync_ms(final)
        rows.append((t_an, t_prep, t_planes, t_ladder, t_final))
    names = ("analysis", "prepare", "planes + sort", "ladder", "final round")
    return {n: sorted(r[i] for r in rows)[len(rows) // 2] for i, n in enumerate(names)}


def device_groups(prof, kernels):
    """(device busy ms, {group: {"ms", "count"}}) of a profile: the
    kernels named in ``kernels``, float32 GEMMs, everything else."""
    from torch.autograd import DeviceType

    groups = {name: [0.0, 0] for name in (*kernels, "gemm", "other")}
    busy = 0.0
    for e in prof.key_averages():
        # device-side events only: a CPU op's self device time repeats
        # the time of the kernels it launched
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us <= 0:
            continue
        busy += us
        key = next((w for w in kernels if w in e.key), None)
        if key is None:
            key = "gemm" if "gemm" in e.key.lower() else "other"
        groups[key][0] += us / 1e3
        groups[key][1] += e.count
    return busy / 1e3, {k: {"ms": v[0], "count": v[1]} for k, v in groups.items()}


def device_view(cfg, blocks):
    from torch.profiler import ProfilerActivity, profile

    from ulcx_torch.parallel.mesh import batch_encode

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _sync_ms(lambda: batch_encode(blocks, cfg, "cbr", rate_kbps=RATE_KBPS))
    busy, groups = device_groups(prof, WALKS)
    return wall, busy, groups


def warm_steps(cfg, blocks, runs=5):
    """ms per block step of ``runs`` warm, unprofiled batch_encode calls."""
    from ulcx_torch.parallel.mesh import batch_encode

    return [_sync_ms(lambda: batch_encode(blocks, cfg, "cbr", rate_kbps=RATE_KBPS))[1]
            / blocks.shape[1] for _ in range(runs)]


def main(variant: str = "loop") -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_profile_encode: no CUDA device", file=sys.stderr)
        return 1
    sys.modules["jax"] = None
    sys.modules["ulcx"] = None
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from bench import make_corpus
    from torch_fold_rtf import variant_config  # the same names for the same knobs
    from ulcx_torch.parallel.mesh import batch_encode

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    cfg = variant_config(variant)
    print(f"variant {variant}: fold_bitstream={cfg.fold_bitstream}, flat_stream={cfg.flat_stream}",
          flush=True)
    blocks = torch.from_numpy(make_corpus(B, T, BS)).cuda()
    batch_encode(blocks, cfg, "cbr", rate_kbps=RATE_KBPS)  # build and warm up
    lay = None
    if variant == "loop":
        layers(cfg, blocks)
        lay = layers(cfg, blocks)
        print("host-synced layers, ms per block step: " +
              ", ".join(f"{k} {v:.3f}" for k, v in lay.items()) + f" (sum {sum(lay.values()):.3f})",
              flush=True)
    steps = warm_steps(cfg, blocks)
    print("unprofiled batch_encode, ms per block step: " + ", ".join(f"{v:.2f}" for v in steps),
          flush=True)
    wall, busy, groups = device_view(cfg, blocks)
    print(f"profiled batch_encode B={B} T={T}: wall {wall:.1f} ms ({wall / T:.2f} a step), "
          f"device busy {busy:.1f} ms = {100 * busy / wall:.1f} %", flush=True)
    for k, v in groups.items():
        per = f", {v['ms'] / v['count']:.4f} ms a launch" if k in WALKS and v["count"] else ""
        print(f"  {k}: {v['ms']:.2f} ms over {v['count']} launches{per}", flush=True)
    print(json.dumps({"card": card, "variant": variant, "layers_ms": lay, "step_ms": steps, "wall_ms": wall,
                      "busy_ms": busy,
                      "busy_share": busy / wall, "groups": groups}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
