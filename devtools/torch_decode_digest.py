#!/usr/bin/env python3
"""SHA-256 digests of what the PyTorch port decodes at the flagship shape, on one card.

    python3 devtools/torch_decode_digest.py     # from the repo root; one CUDA GPU

Encodes B=512 streams x T=8 blocks of stereo bs2048 ``bench.make_corpus``
at CBR-128, packs the streams as ``chip_smoke.py`` does, decodes them with
``batch_decode``, and prints one JSON line with the digests of the packed
streams and of the decoded PCM, bits and corrupt flags (raw bytes). Two
trees that print the same line decode the same streams bit-identically:
run it in each (the other tree unpacked with ``git archive``) in one
call. Imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_digest: no CUDA device", file=sys.stderr)
        return 1
    sys.modules["jax"] = None
    sys.modules["ulcx"] = None
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from bench import make_corpus
    from ulcx_torch.parallel.mesh import batch_decode, batch_encode
    from ulcx_torch.utils.config import CodecConfig

    cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=cs.BS)
    x = torch.from_numpy(make_corpus(cs.MAIN_B, cs.MAIN_T, cs.BS))
    out, _ = batch_encode(x, cfg, "cbr", rate_kbps=cs.RATE_KBPS)
    streams, _, win, _ = cs.pack_streams(out)
    pcm, bits, corrupt = batch_decode(streams, cs.MAIN_T, win, cfg)
    digest = {"card": cs.card_line(), "window_bytes": win}
    for name, t in (("streams", streams), ("pcm", pcm), ("bits", bits), ("corrupt", corrupt)):
        raw = t.detach().cpu().contiguous().numpy().tobytes()
        digest[name] = hashlib.sha256(raw).hexdigest()
    print(json.dumps(digest), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
