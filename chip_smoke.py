#!/usr/bin/env python3
"""Drive the PyTorch port's batched encode path on one CUDA card.

    python3 chip_smoke.py        # from the repo root; one CUDA GPU, nvcc on the machine

Phases, each of which raises on failure:

1. device: require CUDA, turn TF32 off, print the card's name and power limit;
2. build the four encode-walk kernels from ``ulcx_torch/csrc``;
3. kernels vs plain: one block step's walk planes at the flagship shape
   (stereo bs2048, P=4096, from ``bench.make_corpus``), at B=128 and at
   the main path's B=512, go through each kernel and its plain PyTorch
   version on the card; every output must be identical, and both are
   timed;
4. main path: ``batch_encode`` CBR-128 at B=512, T=8 on the card; every
   block within its budget, the launch counters exactly T x (3, 3, 2, 1),
   a second run byte-identical; prints the encode realtime factor;
5. CUDA vs CPU: B=8, T=2 through the same path on the CPU (the plain
   walks); window control and coded counts exact, total size within 1 %.

The second-to-last line is a JSON object with each kernel's launches on
the main path, its largest difference from the plain version and both
times at the main path's B=512; the last is ``{"ok": true, "device": {...}}``. The script exits
non-zero, printing neither, when there is no CUDA device or any phase
fails. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BS = 2048
RATE_KBPS = 128.0
CBR_BUDGET = 5944  # bits per block: CBR 128 kbps at bs2048, 44.1 kHz
KERNEL_B = 128
MAIN_B, MAIN_T = 512, 8
CPU_B, CPU_T = 8, 2
WARMUP_LAUNCHES, TIMED_LAUNCHES = 10, 50  # warm-up lets the clocks ramp after the plain run
WARM_RUNS = 3
SOURCE = "ulcx_torch/csrc/encode_walks.cu"
REPLACES = {
    "p1": "ulcx/bitstream/pallas_encode3.py:124",
    "p2": "ulcx/bitstream/pallas_encode3.py:186",
    "p3_size": "ulcx/bitstream/pallas_encode3.py:254",
    "p3_materialize": "ulcx/bitstream/pallas_encode3.py:254",
}
PER_BLOCK = {"p1": 3, "p2": 3, "p3_size": 2, "p3_materialize": 1}


def phase(name):
    print(f"--- {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def analyze(x, cfg, device):
    """Analyse x [B, T, 2, N] (numpy) on ``device`` from a fresh carry:
    (the last block's AnalyzedBlock, n_nz [B, T] on the CPU)."""
    import torch

    from ulcx_torch.analysis.batched import analyze_block_batched
    from ulcx_torch.codec.encoder import init_carry_batched

    blocks = torch.from_numpy(x).to(device)
    carry = init_carry_batched(cfg, blocks.shape[0], device)
    n_nz = []
    for j in range(blocks.shape[1]):
        carry, blk = analyze_block_batched(carry, blocks[:, j], cfg)
        n_nz.append(blk.n_nz.cpu())
    return blk, torch.stack(n_nz, dim=1)


def kernels_vs_plain(cfg, x, device):
    """Phase 3: every kernel against its plain version on the planes of
    one block step; returns {name: (max_abs_err, kernel ms, plain ms)}."""
    import torch

    from ulcx_torch.bitstream import encode_kernels as ek
    from ulcx_torch.bitstream import fast_encode as fe
    from ulcx_torch.codec.encoder import max_block_bytes

    blk, _ = analyze(x, cfg, device)
    fb = fe.prepare_fast(blk, cfg)
    pl = fe.make_planes(fb)
    # the first ladder round's candidates: n_nz * (1..8) / 8
    steps = torch.arange(1, fe.N_CAND + 1, dtype=torch.int32, device=device)
    nn = ((blk.n_nz[:, None] + fe.N_CAND - 1) // fe.N_CAND) * steps
    nn = torch.minimum(nn, blk.n_nz[:, None]).to(torch.int32)
    t, c = fe._tc_of(pl, nn)
    n_words = max_block_bytes(cfg) // 4
    calls = {
        "p1": (ek.p1, ek.p1_plain, lambda: (t, c, pl.key, pl.coef, pl.aux)),
        "p2": (ek.p2, ek.p2_plain, lambda: (t, c, pl.key, pl.thr, pl.aux, s12)),
        "p3_size": (ek.p3_size, ek.p3_size_plain, lambda: (pl.thr, pl.aux, state)),
        "p3_materialize": (
            ek.p3_materialize, ek.p3_materialize_plain,
            lambda: (pl.coef, pl.ampn, pl.hfamp, pl.hfmeta, pl.aux, state, pl.hdr, n_words),
        ),
    }

    def timed(fn, args, reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn(*args)
        stop.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(stop) / reps

    results = {}
    s12 = state = None
    for name, (kernel, plain, make_args) in calls.items():
        args = make_args()
        want, plain_ms = timed(plain, args, 1)
        for _ in range(WARMUP_LAUNCHES):
            kernel(*args)
        got, ms = timed(kernel, args, TIMED_LAUNCHES)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        err = 0
        for w, g in zip(want, got):
            if w.shape != g.shape or w.dtype != g.dtype:
                raise AssertionError(f"{name}: {g.shape} {g.dtype} vs plain {w.shape} {w.dtype}")
            err = max(err, int((g.long() - w.long()).abs().max()))
        if err:
            raise AssertionError(f"{name}: kernel differs from its plain version by {err}")
        results[name] = (err, ms, plain_ms)
        print(f"{name}: identical to plain; kernel {ms:.4f} ms, plain {plain_ms:.1f} ms", flush=True)
        if name == "p1":
            s12 = got[0]
        elif name == "p2":
            state = got[0]
    return results


def check_encoded(sizes, data, b, t, cfg, label):
    """Every block within the CBR budget, and no byte set past its size."""
    import torch

    from ulcx_torch.codec.encoder import cbr_bit_budget

    budget = int(cbr_bit_budget(cfg, RATE_KBPS))
    if tuple(sizes.shape) != (b, t):
        raise AssertionError(f"{label}: size_bits shape {tuple(sizes.shape)}")
    if int(sizes.max()) > budget or int(sizes.min()) <= 0:
        raise AssertionError(f"{label}: block sizes outside (0, {budget}]: "
                             f"{int(sizes.min())}..{int(sizes.max())}")
    pos = torch.arange(data.shape[-1], device=sizes.device) * 8
    if bool(((pos >= sizes[..., None]) & (data != 0)).any()):
        raise AssertionError(f"{label}: bytes set past a block's size")


def main_path(cfg, x, device):
    """Phase 4: returns (launch counts, warm seconds of each repeat,
    seconds of audio)."""
    import torch

    from ulcx_torch.bitstream import encode_kernels as ek
    from ulcx_torch.parallel.mesh import batch_encode

    blocks = torch.from_numpy(x).to(device)
    b, t = blocks.shape[:2]
    ek.reset_launch_counts()
    t0 = time.perf_counter()
    out, stats = batch_encode(blocks, cfg, "cbr", rate_kbps=RATE_KBPS)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    counts = ek.launch_counts()
    want = {k: t * v for k, v in PER_BLOCK.items()}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    check_encoded(out.size_bits, out.data, b, t, cfg, "main path")

    warm = []
    for _ in range(WARM_RUNS):
        t0 = time.perf_counter()
        again, _ = batch_encode(blocks, cfg, "cbr", rate_kbps=RATE_KBPS)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        if not (torch.equal(out.data, again.data) and torch.equal(out.size_bits, again.size_bits)):
            raise AssertionError("a second run gave other bytes")
    print(f"encode B={b} T={t}: cold {cold:.3f} s, warm {', '.join(f'{w:.3f}' for w in warm)} s, "
          f"total {int(stats['total_bits'])} bits", flush=True)
    return counts, warm, b * t * cfg.block_size / cfg.rate_hz


def cuda_vs_cpu(cfg, x, devices=("cuda", "cpu")):
    """Phase 5: the CPU port (plain walks) against the card."""
    import torch

    from ulcx_torch.parallel.mesh import batch_encode

    res = {}
    for dev in devices:
        out, _ = batch_encode(torch.from_numpy(x).to(dev), cfg, "cbr", rate_kbps=RATE_KBPS)
        res[dev] = (out.window_ctrl.cpu(), analyze(x, cfg, dev)[1], out.size_bits.cpu(),
                    out.data.cpu())
    (wg, ng, sg, dg), (wc, nc, sc, dc) = (res[d] for d in devices)
    check_encoded(sc, dc, x.shape[0], x.shape[1], cfg, "cpu port")
    if not torch.equal(wg, wc):
        raise AssertionError(f"window_ctrl differs:\n{wg}\n{wc}")
    if not torch.equal(ng, nc):
        raise AssertionError(f"n_nz differs:\n{ng}\n{nc}")
    tot_g, tot_c = int(sg.sum()), int(sc.sum())
    rel = abs(tot_g - tot_c) / tot_c
    if rel > 0.01:
        raise AssertionError(f"total bits {tot_g} (cuda) vs {tot_c} (cpu): {rel:.4%}")
    same = sum(torch.equal(dg[i, j], dc[i, j]) for i in range(x.shape[0]) for j in range(x.shape[1]))
    print(f"cuda vs cpu B={x.shape[0]} T={x.shape[1]}: window_ctrl and n_nz equal, total bits "
          f"{tot_g} vs {tot_c} ({rel:.4%}), {same}/{x.shape[0] * x.shape[1]} blocks "
          f"byte-identical", flush=True)


def main() -> int:
    import torch

    phase("1 device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a card",
              file=sys.stderr)
        return 1
    sys.modules.setdefault("jax", None)  # the port must not need it
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    from bench import make_corpus
    from ulcx_torch import _build
    from ulcx_torch.codec.encoder import cbr_bit_budget
    from ulcx_torch.utils.config import CodecConfig

    phase("2 build")
    path, secs = _build.build()
    _build.library()
    print(f"built {path.name} in {secs:.1f} s", flush=True)
    report = path.with_suffix(".ptxas.txt")
    if report.exists():  # absent when the library was already built
        for line in report.read_text().splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print("ptxas:", line.strip(), flush=True)

    cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=BS)
    if int(cbr_bit_budget(cfg, RATE_KBPS)) != CBR_BUDGET:
        raise AssertionError("CBR-128 bs2048 budget is not 5944 bits")
    x = make_corpus(MAIN_B, MAIN_T, BS)
    phase("3 kernels vs plain")
    kres = {}
    for b in (KERNEL_B, MAIN_B):
        print(f"B={b}, P={2 * BS}:", flush=True)
        kres[b] = kernels_vs_plain(cfg, x[:b, :2].copy(), "cuda")

    phase("4 main path")
    counts, warm, audio_s = main_path(cfg, x, "cuda")
    med = sorted(warm)[len(warm) // 2]
    print(f"realtime factor {audio_s / med:.1f}x (median of {len(warm)}: {audio_s:.1f} s of audio "
          f"in {med:.3f} s), launches {counts} [{card}]", flush=True)

    phase("5 cuda vs cpu")
    cuda_vs_cpu(cfg, x[:CPU_B, :CPU_T].copy())

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": counts[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        for name, (err, ms, plain_ms) in kres[MAIN_B].items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
