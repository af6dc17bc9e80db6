#!/usr/bin/env python3
"""Where a decoded block of the PyTorch port spends its time, on one card.

    python3 devtools/torch_profile_decode.py     # from the repo root; one CUDA GPU

Flagship shape: stereo bs2048, the port's own CBR-128 encode of B=512
streams x T=8 blocks of ``bench.make_corpus``, packed and windowed as
``chip_smoke.py`` does (window = largest block rounded up to 64 bytes,
plus 64, as ``bench.py`` sizes it). Prints

1. host-synchronised layers, ms per block (median over the T blocks of
   the second of two passes), the same calls as
   ``decoder.decode_stream_batched`` and ``fast_decode.decode_block_fast``:
   window gather, nybbles + token plane, FSM + placement (the placing
   FSM kernel; on a tree from before it, the FSM kernel and the record
   scatter together), RNG-expand, corrupt mask + transpose, inverse
   transform, inverse M/S, offset advance, each ending in a synchronise;
2. ms per block of five warm, unprofiled ``batch_decode`` calls;
3. the device view of one warm ``batch_decode`` under ``torch.profiler``:
   its wall time, device busy time and share (kernels run on one stream,
   so their sum is their union), and device ms by group: the two decode
   kernels by name, float32 GEMMs, everything else (which holds the
   record scatter's kernels on a tree from before the placing FSM);

then one JSON line with the same numbers. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, BS, RATE_KBPS = 512, 8, 2048, 128.0
KERNELS = ("fsm_kernel", "rng_kernel<true>")  # fsm_kernel<true> too, by its prefix


def layers(cfg, streams, win):
    """Per block, host-synced ms of each layer of decode_stream_batched."""
    import torch

    from torch_profile_encode import _sync_ms
    from ulcx_torch.bitstream import decode_kernels as dk
    from ulcx_torch.bitstream import fast_decode as fd
    from ulcx_torch.codec.decoder import DecoderCarry, inverse_ms
    from ulcx_torch.codec.transform_batched import block_imdct_batched

    b, s_len = streams.shape
    n, c = cfg.block_size, cfg.n_chan
    fsm_place = getattr(dk, "fsm_place", None)
    if fsm_place is None:  # a tree from before the placing kernel: its two steps
        def fsm_place(wc, tokens, p_tot, n):
            rec, code, consumed, corrupt = dk.fsm(wc, tokens, p_tot, n)
            return fd._place(rec, code, p_tot), consumed, corrupt
    lap, prev_ss, seed = DecoderCarry.init(cfg, b, streams.device)
    offset = torch.zeros(b, dtype=torch.int64, device=streams.device)
    span = torch.arange(win, device=streams.device)
    rows = []
    for _ in range(T):
        windows, t_win = _sync_ms(
            lambda: torch.gather(streams, 1, torch.clamp(offset, max=s_len - win)[:, None] + span))
        (wc, hdr, tokens), t_tok = _sync_ms(fd._header_and_tokens, windows)
        (flags, consumed, corrupt), t_fsm = _sync_ms(fsm_place, wc, tokens, n * c, n)
        (coef, seed), t_rng = _sync_ms(dk.rng_expand, flags, seed)
        coefs, t_mask = _sync_ms(
            lambda: torch.where((corrupt == 1)[None], 0.0, coef).T.contiguous().reshape(-1, c, n))
        (pcm, lap, prev_ss), t_imdct = _sync_ms(block_imdct_batched, coefs, wc, lap, prev_ss, cfg)
        _, t_ms = _sync_ms(inverse_ms, pcm)
        bits = 4 * (hdr + consumed)
        offset, t_off = _sync_ms(lambda: offset + (bits + 7) // 8)
        rows.append((t_win, t_tok, t_fsm, t_rng, t_mask, t_imdct, t_ms, t_off))
    names = ("window gather", "nybbles + tokens", "FSM + placement", "RNG-expand",
             "corrupt mask + transpose", "inverse transform", "inverse M/S", "offset advance")
    return {nm: sorted(r[i] for r in rows)[len(rows) // 2] for i, nm in enumerate(names)}


def device_view(cfg, streams, win):
    from torch_profile_encode import _sync_ms, device_groups
    from torch.profiler import ProfilerActivity, profile

    from ulcx_torch.parallel.mesh import batch_decode

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _sync_ms(lambda: batch_decode(streams, T, win, cfg))
    busy, groups = device_groups(prof, KERNELS)
    return wall, busy, groups


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_profile_decode: no CUDA device", file=sys.stderr)
        return 1
    sys.modules["jax"] = None
    sys.modules["ulcx"] = None
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "devtools"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from bench import make_corpus
    from chip_smoke import pack_streams
    from torch_profile_encode import _sync_ms
    from ulcx_torch.parallel.mesh import batch_decode, batch_encode
    from ulcx_torch.utils.config import CodecConfig

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=BS)
    out, _ = batch_encode(torch.from_numpy(make_corpus(B, T, BS)).cuda(), cfg, "cbr",
                          rate_kbps=RATE_KBPS)
    streams, _, win, _ = pack_streams(out)
    streams = streams.cuda()
    batch_decode(streams, T, win, cfg)  # warm up
    layers(cfg, streams, win)
    lay = layers(cfg, streams, win)
    print(f"window {win} bytes; host-synced layers, ms per block: " +
          ", ".join(f"{k} {v:.3f}" for k, v in lay.items()) + f" (sum {sum(lay.values()):.3f})",
          flush=True)
    blocks = [_sync_ms(lambda: batch_decode(streams, T, win, cfg))[1] / T for _ in range(5)]
    print("unprofiled batch_decode, ms per block: " + ", ".join(f"{v:.3f}" for v in blocks),
          flush=True)
    wall, busy, groups = device_view(cfg, streams, win)
    print(f"profiled batch_decode B={B} T={T}: wall {wall:.1f} ms ({wall / T:.2f} a block), "
          f"device busy {busy:.1f} ms = {100 * busy / wall:.1f} %", flush=True)
    for k, v in groups.items():
        per = f", {v['ms'] / v['count']:.4f} ms a launch" if k in KERNELS and v["count"] else ""
        print(f"  {k}: {v['ms']:.2f} ms over {v['count']} launches{per}", flush=True)
    print(json.dumps({"card": card, "window_bytes": win, "layers_ms": lay, "block_ms": blocks,
                      "wall_ms": wall, "busy_ms": busy, "busy_share": busy / wall,
                      "groups": groups}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
