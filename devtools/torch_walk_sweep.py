#!/usr/bin/env python3
"""Launch geometry of the port's p2/p3 walk kernels, swept on one card.

    python3 devtools/torch_walk_sweep.py     # from the repo root; one CUDA GPU

On the planes of the first ladder round at the flagship shape (stereo
bs2048, P=4096, B=512 streams of ``bench.make_corpus``), launches p2,
p3 size and p3 materialize through their C entry points at each chunk
length and helper-warp count below, checks every output identical to
the wrappers' default geometry, and prints ms per launch (CUDA events,
mean of 30 after 5 warm-up launches). Imports nothing of JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, BS = 512, 2048
CHUNKS = (64, 128, 256)
HELPERS = (1, 3, 7)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_walk_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.modules["jax"] = None
    sys.modules["ulcx"] = None
    sys.path.insert(0, HERE)
    from bench import make_corpus
    from chip_smoke import analyze, timed
    from ulcx_torch._build import launch
    from ulcx_torch.bitstream import encode_kernels as ek
    from ulcx_torch.bitstream import fast_encode as fe
    from ulcx_torch.codec.encoder import max_block_bytes
    from ulcx_torch.utils.config import CodecConfig

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=BS)
    blk, _ = analyze(make_corpus(B, 2, BS), cfg, dev)
    pl = fe.make_planes(fe.prepare_fast(blk, cfg))
    steps = torch.arange(1, fe.N_CAND + 1, dtype=torch.int32, device=dev)
    nn = torch.minimum(((blk.n_nz[:, None] + 7) // 8) * steps, blk.n_nz[:, None]).to(torch.int32)
    t, c = fe._tc_of(pl, nn)
    n_pos = pl.key.shape[0]
    n_words = max_block_bytes(cfg) // 4
    s12 = ek.p1(t, c, pl.key, pl.coef, pl.aux)
    state = ek.p2(t, c, pl.key, pl.thr, pl.aux, s12)

    def outs(kind):
        empty = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)  # noqa: E731
        if kind == "p2":
            return ("ulcx_p2", (t, c, pl.key, pl.thr, pl.aux, s12), (empty(n_pos, B, 8),), ())
        if kind == "p3_size":
            return ("ulcx_p3_size", (pl.thr, pl.aux, state), (empty(B, 8),), ())
        return ("ulcx_p3_materialize", (pl.aux, state, pl.coef, pl.ampn, pl.hfamp, pl.hfmeta,
                                        pl.hdr),
                (empty(B, 8), empty(B, 8, n_words), empty(B, 8), empty(B, 8)), (n_words,))

    want = {"p2": (state,), "p3_size": (ek.p3_size(pl.thr, pl.aux, state),),
            "p3_materialize": ek.p3_materialize(pl.coef, pl.ampn, pl.hfamp, pl.hfmeta, pl.aux,
                                                state, pl.hdr, n_words)}
    for kind in ("p2", "p3_size", "p3_materialize"):
        for chunk in CHUNKS:
            for helpers in HELPERS:
                g = ek.walk_geometry(kind, n_pos, B, chunk, helpers)
                if g["smem"] > ek.SMEM_LIMIT:
                    print(f"{kind} chunk {chunk} helpers {helpers}: {g['smem']} bytes, over the limit")
                    continue
                name, ins, outs_, ints = outs(kind)
                geo = (g["chunk"], g["threads"], g["smem"])
                run = lambda: launch(name, (*ins, *outs_), (B, n_pos, *ints, *geo), dev)  # noqa: E731
                for _ in range(5):
                    run()
                _, ms = timed(run, (), 30)
                same = all(torch.equal(o, w) for o, w in zip(outs_, want[kind]))
                print(f"{kind} chunk {chunk} helpers {helpers} smem {g['smem']}: {ms:.4f} ms, "
                      f"{'identical' if same else 'DIFFERS'}", flush=True)
                if not same:
                    return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
