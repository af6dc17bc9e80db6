#!/usr/bin/env python3
"""Launch geometry of the port's ring-buffered walk kernels, swept on one card.

    python3 devtools/torch_walk_sweep.py [KIND ...]   # from the repo root; one CUDA GPU

KIND is any of p1, p2, p3_size, p3_materialize, fsm, fsm_place,
rng_expand, rng (all by default).

At the flagship shape (stereo bs2048, P=4096, B=512 streams of
``bench.make_corpus``):

- p1, p2, p3 size and p3 materialize on the planes of the first ladder
  round, at each chunk length and helper-warp count below;
- the FSM in its record and its placing mode on the token plane of the
  first block of those streams' CBR-128 encode (window sized as
  ``chip_smoke.pack_streams`` sizes it), at each stream count per CTA
  and helper-warp count below;
- RNG-expand and RNG on that block's expansion flags, at each stream
  count per CTA and helper-warp count below (chunk as the wrappers'
  default);

each launched through its C entry point, every output checked identical
to the wrappers' default geometry, and timed in ms per launch (CUDA
events, mean of 30 after 5 warm-up launches). Imports nothing of JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, BS = 512, 2048
CHUNKS = (64, 128, 256)
HELPERS = (1, 3, 7)
RNG_STREAMS = (4, 8, 16, 32)
KINDS = ("p1", "p2", "p3_size", "p3_materialize", "fsm", "fsm_place", "rng_expand", "rng")


def sweep(label, name, ins, outs, ints, geometries, want, dev) -> bool:
    """Launch entry point ``name`` at each (description, geometry ints)
    and print its time; False as soon as an output differs from
    ``want``."""
    import torch

    from chip_smoke import timed
    from ulcx_torch._build import launch

    for desc, geo in geometries:
        run = lambda: launch(name, (*ins, *outs), (*ints, *geo), dev)  # noqa: E731
        for _ in range(5):
            run()
        _, ms = timed(run, (), 30)
        same = all(torch.equal(o.view(torch.int32), w.view(torch.int32))
                   for o, w in zip(outs, want))
        print(f"{label} {desc} smem {geo[-1]}: {ms:.4f} ms, {'identical' if same else 'DIFFERS'}",
              flush=True)
        if not same:
            return False
    return True


def main(kinds) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_walk_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.modules["jax"] = None
    sys.modules["ulcx"] = None
    sys.path.insert(0, HERE)
    from bench import make_corpus
    from chip_smoke import analyze, pack_streams, stream_seeds
    from ulcx_torch.bitstream import decode_kernels as dk
    from ulcx_torch.bitstream import encode_kernels as ek
    from ulcx_torch.bitstream import fast_decode as fd
    from ulcx_torch.bitstream import fast_encode as fe
    from ulcx_torch.codec.encoder import max_block_bytes
    from ulcx_torch.parallel.mesh import batch_encode
    from ulcx_torch.utils.config import CodecConfig

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=BS)
    x = make_corpus(B, 2, BS)
    blk, _ = analyze(x, cfg, dev)
    pl = fe.make_planes(fe.prepare_fast(blk, cfg))
    steps = torch.arange(1, fe.N_CAND + 1, dtype=torch.int32, device=dev)
    nn = torch.minimum(((blk.n_nz[:, None] + 7) // 8) * steps, blk.n_nz[:, None]).to(torch.int32)
    t, c = fe._tc_of(pl, nn)
    n_pos = pl.key.shape[0]
    n_words = max_block_bytes(cfg) // 4
    s12 = ek.p1(t, c, pl.key, pl.coef, pl.aux)
    state = ek.p2(t, c, pl.key, pl.thr, pl.aux, s12)
    empty = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)  # noqa: E731

    encode = {
        "p1": ("ulcx_p1", (t, c, pl.key, pl.coef, pl.aux), lambda: (empty(n_pos, B, 8),), (),
               (s12,)),
        "p2": ("ulcx_p2", (t, c, pl.key, pl.thr, pl.aux, s12), lambda: (empty(n_pos, B, 8),), (),
               (state,)),
        "p3_size": ("ulcx_p3_size", (pl.thr, pl.aux, state), lambda: (empty(B, 8),), (),
                    (ek.p3_size(pl.thr, pl.aux, state),)),
        "p3_materialize": (
            "ulcx_p3_materialize",
            (pl.aux, state, pl.coef, pl.ampn, pl.hfamp, pl.hfmeta, pl.hdr),
            lambda: (empty(B, 8), empty(B, 8, n_words), empty(B, 8), empty(B, 8)), (n_words,),
            ek.p3_materialize(pl.coef, pl.ampn, pl.hfamp, pl.hfmeta, pl.aux, state, pl.hdr,
                              n_words)),
    }
    for kind, (name, ins, make_outs, extra, want) in encode.items():
        if kind not in kinds:
            continue
        geos = []
        for chunk in CHUNKS:
            for helpers in HELPERS:
                g = ek.walk_geometry(kind, n_pos, B, chunk, helpers)
                if g["smem"] > ek.SMEM_LIMIT:
                    print(f"{kind} chunk {chunk} helpers {helpers}: {g['smem']} bytes, over the "
                          f"limit")
                    continue
                geos.append((f"chunk {chunk} helpers {helpers}",
                             (g["chunk"], g["threads"], g["smem"])))
        if not sweep(kind, name, ins, make_outs(), (B, n_pos, *extra), geos, want, dev):
            return 1

    if not {"fsm", "fsm_place", "rng_expand", "rng"} & set(kinds):
        return 0
    out, _ = batch_encode(torch.from_numpy(x).to(dev), cfg, "cbr", rate_kbps=128.0)
    streams, _, win, _ = pack_streams(out)
    wc, _, tokens = fd._header_and_tokens(streams[:, :win].to(dev))
    t_len = tokens.shape[0]
    flags, _, _ = dk.fsm_place(wc, tokens, n_pos, BS)
    fsm_ins = (wc, tokens, dk._next_end_tensor(BS, dev), dk._syntax_tensor(dev))
    fsm = {
        "fsm": ("ulcx_fsm", lambda: (empty(t_len, B), empty(t_len, B), empty(B), empty(B)),
                dk.fsm(wc, tokens, n_pos, BS)),
        "fsm_place": ("ulcx_fsm_place", lambda: (empty(n_pos, B), empty(B), empty(B)),
                      dk.fsm_place(wc, tokens, n_pos, BS)),
    }
    for kind, (name, make_outs, want) in fsm.items():
        if kind not in kinds:
            continue
        geos = []
        for streams_per_cta in RNG_STREAMS:
            for helpers in HELPERS:
                g = dk.fsm_geometry(t_len, B, streams_per_cta, helpers)
                geos.append((f"streams {streams_per_cta} helpers {helpers}",
                             (g["streams"], g["chunk"], g["threads"], g["smem"])))
        if not sweep(kind, name, fsm_ins, make_outs(), (B, t_len, n_pos, BS), geos, want, dev):
            return 1
    seed = stream_seeds(B, 0).to(dev)
    rng = {
        "rng_expand": ("ulcx_rng_expand", flags, True, dk.rng_expand(flags, seed)),
        "rng": ("ulcx_rng", dk.rng_flags(flags), False, dk.rng(dk.rng_flags(flags), seed)),
    }
    for kind, (name, fl, expand, want) in rng.items():
        if kind not in kinds:
            continue
        geos = []
        for streams_per_cta in RNG_STREAMS:
            for helpers in HELPERS:
                g = dk.rng_geometry(n_pos, B, expand, streams_per_cta, helper_warps=helpers)
                geos.append((f"streams {streams_per_cta} helpers {helpers}",
                             (g["streams"], g["chunk"], g["threads"], g["smem"])))
        outs = (torch.empty(n_pos, B, dtype=torch.float32, device=dev), empty(B))
        if not sweep(kind, name, (fl, seed), outs, (B, n_pos), geos, want, dev):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or KINDS))
