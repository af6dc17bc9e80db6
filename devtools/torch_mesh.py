#!/usr/bin/env python3
"""The PyTorch port's data-parallel path on the cards of one machine.

    python3 devtools/torch_mesh.py [RUNS [B]]   # from the repo root; one or more CUDA GPUs

Runs phases 4, 7 and 17 of ``chip_smoke.py`` alone, with their checks:
``batch_encode`` CBR-128 of B streams (512) x T=8 blocks of stereo bs2048
``bench.make_corpus`` and ``batch_decode`` of its streams in this
process; the same through ``data_mesh()``, a world of one; then
``python -m ulcx_torch.graft_entry mesh`` under torchrun (NCCL over a
card each where two or more are visible, at most four; else two ranks
sharing card 0 over gloo), ``dryrun_multichip`` and ``entry()``. RUNS
(default 3) is the warm repeats of each. Prints the card's name and
power limit, then one JSON line with the realtime factors (seconds of
audio / wall seconds; the mesh's from a barrier before each call to a
barrier after it). Phase 17 is the only one that uses several cards.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(runs: int, b: int) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_mesh: no CUDA device", file=sys.stderr)
        return 1
    sys.modules["jax"] = None
    sys.modules["ulcx"] = None
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from bench import make_corpus
    from ulcx_torch.utils.config import CodecConfig

    cs.WARM_RUNS = cs.MESH_RUNS = runs
    card = cs.card_line()
    print(card, flush=True)
    cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=cs.BS)
    x = make_corpus(b, cs.MAIN_T, cs.BS)
    counts, warm, audio_s, encoded = cs.main_path(cfg, x, "cuda")
    enc_rtf = cs.rtf_line("encode", warm, audio_s, counts, card)
    streams, _, win, sizes = cs.pack_streams(encoded)
    dcounts, dwarm, _, snr, decoded = cs.decode_main_path(cfg, x, streams, win, sizes, "cuda")
    dec_rtf = cs.rtf_line("decode", dwarm, audio_s, dcounts, card)
    cs.mesh_of_one(cfg, x, encoded, decoded, streams, win, sizes, card)
    n, cards, _, rtfs = cs.mesh_ranks(cfg, x, encoded, snr, enc_rtf, dec_rtf, card)
    cs.mesh_dryrun_and_entry(n, card)
    print(json.dumps({"card": card, "devices": torch.cuda.device_count(), "B": b, "ranks": n,
                      "cards": cards, "encode_rtf": enc_rtf, "decode_rtf": dec_rtf,
                      "mesh_encode_rtf": rtfs["encode"], "mesh_decode_rtf": rtfs["decode"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    sys.exit(main(*args, *(3, 512)[len(args):]))
