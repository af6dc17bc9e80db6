"""Encoder state, the analyzed-block record, M/S, and one stream's block analysis.

Port of ``ulcx.analysis.block`` with the stream batch written out: every
leaf has a leading [B]. ``analyze_block`` is ulcx's single-stream form,
its leaves without the batch axis, run as a batch of one through
``analysis.batched.analyze_block_batched``. ``carry_from_numpy`` and
``carry_to_numpy`` move an ``ulcx`` carry (its leaves as numpy arrays)
into the port and back, so a stream begun in one package continues in
the other with the same state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ulcx_torch.analysis.window_control import TransientState
from ulcx_torch.utils.config import CodecConfig

_NEG_LOG4 = float(np.float32(-float.fromhex("0x1.62E430p0")))   # ln(0.25)
_INV_LOG2E = float(np.float32(float.fromhex("0x1.62E430p-1")))  # 1/log2(e) = ln 2


class EncoderCarry(NamedTuple):
    """State carried block to block (reference ULC_EncoderState_t)."""

    sample_prev: torch.Tensor       # [B, C, N] previous M/S'd block
    transient: TransientState
    next_window_ctrl: torch.Tensor  # [B] int32
    prev_last_ss: torch.Tensor      # [B] int32

    @staticmethod
    def init(cfg: CodecConfig, batch: int, device="cuda"):
        return EncoderCarry(
            sample_prev=torch.zeros(
                batch, cfg.n_chan, cfg.block_size, dtype=torch.float32, device=device
            ),
            transient=TransientState.init(batch, device),
            next_window_ctrl=torch.full((batch,), 0x10, dtype=torch.int32, device=device),
            prev_last_ss=torch.full((batch,), cfg.block_size, dtype=torch.int32, device=device),
        )


class AnalyzedBlock(NamedTuple):
    window_ctrl: torch.Tensor   # [B] int32 (for this coded block)
    mdct: torch.Tensor          # [B, C, N] normalized coefficients
    noise: torch.Tensor         # [B, C, N] interleaved {w, w*y} noise pairs
    importance: torch.Tensor    # [B, C, N] f32 masked importance (rank key)
    complexity: torch.Tensor    # [B] f32
    n_nz: torch.Tensor          # [B] int32 (codeable coefficient count)


def map_leaves(fn, x):
    """``fn`` over every tensor leaf of a (possibly nested) NamedTuple."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    return type(x)(*(map_leaves(fn, leaf) for leaf in x))


def analyze_block(carry: EncoderCarry, new_block: torch.Tensor, cfg: CodecConfig):
    """One block of one stream (ulcx ``analysis.block.analyze_block``):
    carry without a batch axis, new_block [C, N] deinterleaved PCM.
    Returns (new carry, AnalyzedBlock) with ulcx's unbatched leaves,
    computed where ``new_block`` lies."""
    from ulcx_torch.analysis.batched import analyze_block_batched  # it imports this module

    carry, blk = analyze_block_batched(map_leaves(lambda x: x[None], carry), new_block[None], cfg)
    return map_leaves(lambda x: x[0], carry), map_leaves(lambda x: x[0], blk)


def carry_from_numpy(carry, device="cuda") -> EncoderCarry:
    """An ``ulcx`` EncoderCarry with batched numpy leaves -> the port's
    carry on ``device``. Fields are read by name."""

    def conv(x, dtype=torch.float32):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    ts = carry.transient
    return EncoderCarry(
        sample_prev=conv(carry.sample_prev),
        transient=TransientState(*(conv(getattr(ts, f)) for f in TransientState._fields)),
        next_window_ctrl=conv(carry.next_window_ctrl, torch.int32),
        prev_last_ss=conv(carry.prev_last_ss, torch.int32),
    )


def carry_to_numpy(carry: EncoderCarry) -> EncoderCarry:
    """The port's carry -> the same structure with numpy leaves, field
    for field what ``ulcx``'s batched carry holds."""

    def conv(x):
        return x.detach().cpu().numpy()

    return EncoderCarry(
        sample_prev=conv(carry.sample_prev),
        transient=TransientState(*(conv(x) for x in carry.transient)),
        next_window_ctrl=conv(carry.next_window_ctrl),
        prev_last_ss=conv(carry.prev_last_ss),
    )


def ms_transform(block: torch.Tensor) -> torch.Tensor:
    """Pairwise M/S on [..., C, N]: (a, b) -> ((a+b)/2, (a-b)/2); an odd
    last channel is untouched (reference ulcEncoder_BlockTransform.c:100-110)."""
    c = block.shape[-2]
    if c < 2:
        return block
    npair = c // 2
    pairs = block[..., : 2 * npair, :].reshape(block.shape[:-2] + (npair, 2, block.shape[-1]))
    mid = (pairs[..., 0, :] + pairs[..., 1, :]) * 0.5
    side = (pairs[..., 0, :] - pairs[..., 1, :]) * 0.5
    out = torch.stack([mid, side], dim=-2).reshape(block.shape[:-2] + (2 * npair, block.shape[-1]))
    if c > 2 * npair:
        out = torch.cat([out, block[..., 2 * npair :, :]], dim=-2)
    return out
