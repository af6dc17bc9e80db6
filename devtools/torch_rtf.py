#!/usr/bin/env python3
"""Encode and decode realtime factors of the PyTorch port, on one card.

    python3 devtools/torch_rtf.py [RUNS]     # from the repo root; one CUDA GPU

Runs phases 4 and 7 of ``chip_smoke.py`` alone, with their checks:
``batch_encode`` CBR-128 of B=512 streams x T=8 blocks of stereo bs2048
``bench.make_corpus``, then ``batch_decode`` of its streams, each with
RUNS warm repeats (7 by default). Prints the card's name and power
limit, then one JSON line with every warm run's realtime factor (seconds
of audio / wall seconds, each run ending in a synchronise). A process
takes seconds, not the minutes of ``chip_smoke.py``'s plain versions,
so one call can alternate many processes of two trees. Imports nothing
of JAX.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(runs: int) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_rtf: no CUDA device", file=sys.stderr)
        return 1
    sys.modules["jax"] = None
    sys.modules["ulcx"] = None
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from bench import make_corpus
    from ulcx_torch.utils.config import CodecConfig

    cs.WARM_RUNS = runs
    card = cs.card_line()
    print(card, flush=True)
    cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=cs.BS)
    x = make_corpus(cs.MAIN_B, cs.MAIN_T, cs.BS)
    _, warm, audio_s, out = cs.main_path(cfg, x, "cuda")
    streams, _, win, sizes = cs.pack_streams(out)
    _, dwarm, _, _, _ = cs.decode_main_path(cfg, x, streams, win, sizes, "cuda")
    print(json.dumps({"card": card, "encode_rtf": [audio_s / w for w in warm],
                      "decode_rtf": [audio_s / w for w in dwarm]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 7))
