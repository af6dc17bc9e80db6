"""One block's token records and their expansion (port of ``ulcx.bitstream.decode``).

ulcx's scan decoder walks a block's nybbles with its state machine in a
``lax.scan`` and emits, per token, a record (type, start, count, level,
decay), then expands the records into coefficients with a scan over
positions that replays the noise RNG. The port keeps ulcx's interface
on its decode kernels:

- ``decode_block_tokens`` runs the state machine in its record mode
  (``decode_kernels.fsm``, the ``fsm_kernel<false>`` that
  ``fast_decode.fsm_records`` launches) and reads ulcx's per-token
  fields off the kernel's record and code words. A record's length is
  not in them: it follows from the token syntax in the mode the token
  was read in, and that mode from the tokens since the last record
  (``_modes``, a prefix composition of the syntax's next-mode maps, no
  loop over tokens);
- ``expand_records`` places the records' words at their starts
  (``decode_kernels.place_records``) and runs the RNG-expand kernel.

On a CPU tensor both kernels' wrappers run their plain versions; with
``use_pallas="off"`` the plain versions run wherever the tensors lie
(``fast_decode.walks``).
``codec.decoder.decode_block`` is built on these two, as ulcx's is.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from ulcx_torch.bitstream import decode_kernels as dk
from ulcx_torch.bitstream.decode_kernels import (  # noqa: F401 (ulcx's names here)
    M_DONE,
    M_LRUN_X,
    M_LRUN_Y,
    M_NOISE_X,
    M_NOISE_Y,
    M_NOISE_Z,
    M_NORMAL,
    M_QUANT_EXT_M,
    M_QUANT_EXT_S,
    M_QUANT_MID,
    M_QUANT_START,
    M_TAIL_X,
    M_TAIL_Y,
    M_TAIL_Z,
    M_ZSHORT,
    REC_COEF,
    REC_NOISE,
    REC_NONE,
    REC_TAIL,
    REC_ZERO,
)
from ulcx_torch.bitstream.fast_decode import walks
from ulcx_torch.bitstream.tables import segment_tables
from ulcx_torch.utils.config import CodecConfig

_I32 = torch.int32


class Records(NamedTuple):
    """ulcx's per-token records [T], with the kernel's words they come from.
    Where a token ends no record, emit is False, rtype REC_NONE, count,
    level and decay 0, and start the cursor (the position the next
    record starts at)."""

    emit: torch.Tensor    # [T] bool
    rtype: torch.Tensor   # [T] i32
    start: torch.Tensor   # [T] i32
    count: torch.Tensor   # [T] i32
    level: torch.Tensor   # [T] f32 (coefficient value / noise level)
    decay: torch.Tensor   # [T] f32
    rec: torch.Tensor     # [T] i32 record word: start | type << 23 (decode_kernels)
    code: torch.Tensor    # [T] i32 code word: level a | decay dn << 5 | quantizer << 13


@lru_cache(maxsize=16)
def _segments(block_size: int, n_chan: int, device: torch.device):
    """(segment-start flags, segment ends) [16, P + 1]: the pattern's
    tables with P appended (a start and its own end)."""
    starts, ends, _ = segment_tables(block_size, n_chan)
    p_tot = starts.shape[1]
    idx = torch.arange(p_tot + 1)
    is_start = torch.cat([torch.from_numpy(starts) == idx[:p_tot],
                          torch.ones((16, 1), dtype=torch.bool)], 1)
    end = torch.cat([torch.from_numpy(ends), torch.full((16, 1), p_tot, dtype=_I32)], 1)
    return is_start.to(device), end.long().to(device)


@lru_cache(maxsize=16)
def _syntax(device: torch.device) -> dict:
    """The syntax tables a record's length needs, on ``device`` (one copy,
    so no call copies from the host): next mode [16, 16], and per
    (mode, nybble) the run form (run, n0, nmul) [256]."""
    tab = dk._syntax_tables()
    out = {k: torch.from_numpy(tab[k]).to(device) for k in ("run", "n0", "nmul")}
    out["next"] = torch.from_numpy(tab["next"]).to(device).reshape(16, 16)
    return out


def _modes(tokens: torch.Tensor, emit: torch.Tensor, after: torch.Tensor) -> torch.Tensor:
    """The state machine's mode before each token [T]: a token that ends
    no record moves by the syntax's next-mode table, one that ends a
    record to ``after`` (the mode its end leaves). The maps of the tokens
    before each one are composed in log2(T) doubling steps."""
    t_len = tokens.shape[0]
    maps = _syntax(tokens.device)["next"][:, tokens].T  # [T, 16]: mode before -> after token t
    maps = torch.where(emit[:, None], after[:, None], maps)
    d = 1
    while d < t_len:  # maps[t] becomes the composition of tokens t - 2d + 1 .. t
        maps = torch.cat([maps[:d], torch.gather(maps[d:], 1, maps[:-d])])
        d *= 2
    first = torch.full((1,), dk.M_QUANT_START, dtype=maps.dtype, device=maps.device)
    return torch.cat([first, maps[:-1, dk.M_QUANT_START]])


def _records(rec: torch.Tensor, code: torch.Tensor, tokens: torch.Tensor, window_ctrl,
             cfg: CodecConfig) -> Records:
    """ulcx's record fields [T] from the record-mode FSM's words of one
    block and its tokens [T]."""
    n, c = cfg.block_size, cfg.n_chan
    p_tot = n * c
    dev = rec.device
    rtype = (rec >> dk.REC_START_BITS) & 0x7
    emit = rtype != dk.REC_NONE
    at = (rec & dk.REC_START_MASK).long()
    is_start, seg_end = (t[(window_ctrl >> 4).long()] for t in _segments(n, c, dev))

    # the mode a record's end leaves: a segment start (the next record's
    # start is one) begins with its quantizer; the last record's is never read
    t_len = rec.shape[0]
    tok_idx = torch.arange(t_len, device=dev)
    later = torch.where(emit, tok_idx, t_len).flip(0).cummin(0).values.flip(0)
    nxt_rec = torch.cat([later[1:], later.new_full((1,), t_len)])
    nxt_start = torch.cat([at, at.new_full((1,), p_tot)])[nxt_rec]
    after = torch.where(is_start[nxt_start], dk.M_QUANT_START, dk.M_NORMAL)
    x = tokens.long()
    mode = _modes(x, emit, after)

    # a run's length from the token and the run register (the tokens
    # before it: Y for a long zero run, Z and Y for noise); a coefficient
    # takes one position; a quantizer stop and a tail run to the segment end
    tab = _syntax(dev)
    idx = mode * 16 + x
    n0, nmul, run = (tab[k][idx] for k in ("n0", "nmul", "run"))
    x1 = torch.cat([x.new_zeros(1), x[:-1]])
    x2 = torch.cat([x.new_zeros(2), x[:-2]])[:t_len]
    r0 = torch.where(mode == dk.M_NOISE_X, ((x2 << 4) | x1) & 0xFF, x1)
    extent = torch.where(run == 1, n0 + r0 * nmul,
                         torch.where(rtype == dk.REC_COEF, 1, seg_end[at] - at))
    count = torch.where(emit, extent, 0)
    cursor = torch.where(emit, at + count, 0).cummax(0).values
    start = torch.cat([cursor.new_zeros(1), cursor[:-1]])

    kind = ((rtype == dk.REC_COEF).to(_I32) << 2) | ((rtype == dk.REC_TAIL).to(_I32) << 3)
    level, decay = dk._levels(kind | (code << 4))
    zero = torch.zeros_like(level)
    return Records(emit, rtype.to(_I32), start.to(_I32), count.to(_I32),
                   torch.where(emit, level, zero), torch.where(emit, decay, zero), rec, code)


def decode_block_tokens(tokens: torch.Tensor, window_ctrl: torch.Tensor, cfg: CodecConfig):
    """Run the state machine over one block's token nybbles [T] (header
    stripped) with its window control (0-d). Returns (Records [T],
    tokens consumed (0-d i32, the one that ends the block included),
    corrupt (0-d bool: the block did not end within the tokens))."""
    wc = torch.as_tensor(window_ctrl, dtype=_I32).to(tokens.device).reshape(1)
    tok = tokens.to(_I32).reshape(-1, 1).contiguous()
    p_tot = cfg.block_size * cfg.n_chan
    rec, code, consumed, corrupt = walks(cfg).fsm(wc, tok, p_tot, cfg.block_size)
    return _records(rec[:, 0], code[:, 0], tok[:, 0], wc[0], cfg), consumed[0], corrupt[0] == 1


def expand_records(records: Records, rng_state: torch.Tensor, p_tot: int,
                   rng_expand=dk.rng_expand):
    """Records -> coefficients [P] f32 and the new RNG state. rng_state
    is 0-d int32 holding the u32 xorshift32 state's bits, carried across
    blocks. The records' words go to their starts, then the RNG-expand
    walk ``rng_expand`` (the kernel, or its plain version: the pick of
    ``fast_decode.walks``) replays the noise and fills the records.

    As in ulcx's scan expansion, a position takes the record that
    starts last at or before it, so past the last record of a block
    that did not end (corrupt or cut short) a coefficient record's value
    repeats to the block's end, where the RNG walk writes it once (a
    draw record's region runs to the end in both). Decoders zero a
    corrupt block's coefficients either way."""
    flags = dk.place_records(records.rec[:, None], records.code[:, None], p_tot)
    seed = torch.as_tensor(rng_state, dtype=_I32).to(flags.device).reshape(1)
    coef, seed = rng_expand(flags, seed)
    t_len = records.emit.shape[0]
    last = torch.where(records.emit, torch.arange(t_len, device=flags.device), -1).amax()
    j = last.clamp(min=0)
    pos = torch.arange(p_tot, device=flags.device)
    fill = ((last >= 0) & (records.rtype[j] == dk.REC_COEF)
            & (pos >= records.start[j] + records.count[j]))
    return torch.where(fill, records.level[j], coef[:, 0]), seed[0]
