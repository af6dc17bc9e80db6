#!/usr/bin/env python3
"""Why ``flat_stream`` does not give the per-block loop's bytes everywhere, on one card.

    python3 devtools/torch_flat_nearties.py     # from the repo root; one CUDA GPU

Flagship shape (stereo bs2048, CBR-128, B=512 x T=8 of
``bench.make_corpus``). Analyses the blocks twice from the same carry,
block by block (``analyze_block_batched``) and all at once
(``analyze_stream_batched``), whose transform products run at another
batch size and so sum in another order, and prints how far the two
analyses are apart: window control and coded counts (decisions), the
MDCT in units of the block's largest magnitude, the importance keys.
Then encodes both ways and, for every block whose size differs, finds
the first rank at which the two importance orders part and prints the
gap between the two keys that swapped there beside the largest
difference between the two analyses' keys of that block: a gap no
larger than that difference is a near-tie that rounding decides. For the
blocks whose size differs although the order is the same, it codes the
block-by-block analysis again with the importance, the MDCT or the
noise pairs of the other analysis in its place, and counts the blocks
that this leaf alone brings to ``flat_stream``'s size, beside how far
the two analyses' MDCT and noise are apart there. Ends with one JSON
line. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, BS, RATE_KBPS = 512, 8, 2048, 128.0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_flat_nearties: no CUDA device", file=sys.stderr)
        return 1
    sys.modules["jax"] = None
    sys.modules["ulcx"] = None
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from bench import make_corpus
    from ulcx_torch.analysis.batched import analyze_block_batched, analyze_stream_batched
    from ulcx_torch.codec.encoder import (
        _encode_analyzed_fast, encode_stream_batched, init_carry_batched,
    )
    from ulcx_torch.utils.config import CodecConfig

    card = cs.card_line()
    print(card, flush=True)
    cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=BS)
    blocks = torch.from_numpy(make_corpus(B, T, BS)).cuda()
    carry = init_carry_batched(cfg, B, "cuda")
    per_block = []
    for j in range(T):
        carry, blk = analyze_block_batched(carry, blocks[:, j], cfg)
        per_block.append(blk)
    loop = type(blk)(*(torch.stack(xs, 1) for xs in zip(*per_block)))  # [B, T, ...]
    _, flat = analyze_stream_batched(init_carry_batched(cfg, B, "cuda"), blocks, cfg)
    flat = type(flat)(*(x.reshape((B, T) + x.shape[1:]) for x in flat))

    scale = loop.mdct.abs().amax(dim=(2, 3), keepdim=True)
    finite = torch.isfinite(loop.importance) & torch.isfinite(flat.importance)
    key_diff = torch.where(finite, (loop.importance - flat.importance).abs(), 0.0)
    res = {
        "card": card,
        "window_ctrl_equal": bool(torch.equal(loop.window_ctrl, flat.window_ctrl)),
        "n_nz_differs_in_blocks": int((loop.n_nz != flat.n_nz).sum()),
        "mdct_max_of_block_max": float(((loop.mdct - flat.mdct).abs() / scale).max()),
        "mdct_share_of_coefficients_that_differ": float((loop.mdct != flat.mdct).float().mean()),
        "importance_max_abs_diff": float(key_diff.max()),
        "importance_isinf_equal": bool(torch.equal(torch.isinf(loop.importance),
                                                   torch.isinf(flat.importance))),
    }
    print(f"analysis, per block vs all at once: window control equal {res['window_ctrl_equal']}, "
          f"n_nz differs in {res['n_nz_differs_in_blocks']} of {B * T} blocks, MDCT apart by at "
          f"most {res['mdct_max_of_block_max']:.3g} of the block maximum "
          f"({res['mdct_share_of_coefficients_that_differ']:.2%} of coefficients differ at all), "
          f"importance keys by at most {res['importance_max_abs_diff']:.3g}", flush=True)

    kw = {"rate_kbps": RATE_KBPS}
    out_l, _ = encode_stream_batched(blocks, cfg, "cbr", **kw)
    out_f, _ = encode_stream_batched(blocks, dataclasses.replace(cfg, flat_stream=True), "cbr", **kw)
    size_differs = out_l.size_bits != out_f.size_bits
    bytes_differ = ~(out_l.data == out_f.data).all(-1)
    order_l = torch.argsort(-loop.importance.reshape(B, T, -1), dim=-1, stable=True)
    order_f = torch.argsort(-flat.importance.reshape(B, T, -1), dim=-1, stable=True)
    order_differs = (order_l != order_f).any(-1)
    res.update(
        blocks=B * T,
        size_differs=int(size_differs.sum()),
        bytes_differ=int(bytes_differ.sum()),
        rank_order_differs=int(order_differs.sum()),
        size_differs_without_rank_difference=int((size_differs & ~order_differs).sum()),
        total_bits_loop=int(out_l.size_bits.sum()), total_bits_flat=int(out_f.size_bits.sum()),
        largest_size_difference_bits=int((out_l.size_bits - out_f.size_bits).abs().max()),
    )
    print(f"encode: size differs in {res['size_differs']} blocks (largest difference "
          f"{res['largest_size_difference_bits']} bits; totals {res['total_bits_loop']} vs "
          f"{res['total_bits_flat']}), bytes in {res['bytes_differ']}, the importance order in "
          f"{res['rank_order_differs']}; size differs with the same order in "
          f"{res['size_differs_without_rank_difference']}", flush=True)

    ties = []
    for b, t in size_differs.nonzero().tolist():
        keys = loop.importance[b, t].reshape(-1)
        ol, of = order_l[b, t], order_f[b, t]
        r = int((ol != of).nonzero()[0]) if bool((ol != of).any()) else -1
        gap = float(keys[ol[r]] - keys[ol[r + 1]]) if r >= 0 else float("nan")
        ties.append({"stream": b, "block": t, "bits_loop": int(out_l.size_bits[b, t]),
                     "bits_flat": int(out_f.size_bits[b, t]), "first_rank_that_differs": r,
                     "gap_between_the_swapped_keys": gap,
                     "largest_key_difference_in_block": float(key_diff[b, t].max()),
                     "n_nz": int(loop.n_nz[b, t])})
    for tie in ties[:12]:
        print("  " + json.dumps(tie), flush=True)
    near = sum(1 for x in ties if x["first_rank_that_differs"] >= 0
               and abs(x["gap_between_the_swapped_keys"]) <= x["largest_key_difference_in_block"])
    res["size_differs_at_a_near_tie"] = near
    res["ties"] = ties
    print(f"{near} of {len(ties)} blocks whose size differs part at a swap of two keys closer "
          f"than the two analyses' keys are to each other", flush=True)

    # what moves the sizes that differ under one and the same order: code
    # the block loop's analysis again with one leaf taken from the other
    # analysis, and count the blocks this alone brings to flat_stream's size
    rest = size_differs & ~order_differs
    flat_1d = type(flat)(*(x.flatten(0, 1) for x in flat))
    loop_1d = type(loop)(*(x.flatten(0, 1) for x in loop))
    if not torch.equal(_encode_analyzed_fast(loop_1d, cfg, "cbr", **kw).size_bits.reshape(B, T),
                       out_l.size_bits):
        raise AssertionError("the block loop's analysis coded as one batch gives other sizes")
    swaps = {}
    for leaf in ("importance", "mdct", "noise"):
        mixed = loop_1d._replace(**{leaf: getattr(flat_1d, leaf)})
        size = _encode_analyzed_fast(mixed, cfg, "cbr", **kw).size_bits.reshape(B, T)
        hit = size == out_f.size_bits
        swaps[leaf] = {"of_all_that_differ": int((hit & size_differs).sum()),
                       "of_those_with_the_same_order": int((hit & rest).sum())}
    both = loop_1d._replace(mdct=flat_1d.mdct, noise=flat_1d.noise)
    hit = _encode_analyzed_fast(both, cfg, "cbr", **kw).size_bits.reshape(B, T) == out_f.size_bits
    swaps["mdct and noise"] = {"of_all_that_differ": int((hit & size_differs).sum()),
                               "of_those_with_the_same_order": int((hit & rest).sum())}
    noise_scale = loop.noise.abs().amax(dim=(2, 3), keepdim=True).clamp_min(1e-30)
    res["same_order"] = {
        "blocks": int(rest.sum()),
        "reach_flat_size_with_one_leaf_of_flat": swaps,
        "mdct_max_of_block_max": float(((loop.mdct - flat.mdct).abs() / scale)[rest].max()),
        "noise_max_of_block_max": float(((loop.noise - flat.noise).abs() / noise_scale)[rest].max()),
        "n_nz_differs": int((loop.n_nz != flat.n_nz)[rest].sum()),
    }
    so = res["same_order"]
    print(f"{so['blocks']} blocks differ in size under the same order; in them the MDCT is apart by "
          f"at most {so['mdct_max_of_block_max']:.3g} and the noise pairs by "
          f"{so['noise_max_of_block_max']:.3g} of the block maximum, n_nz differs in "
          f"{so['n_nz_differs']}; blocks that reach flat_stream's size when the block loop's "
          f"analysis takes one leaf of the other: " + json.dumps(swaps), flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
