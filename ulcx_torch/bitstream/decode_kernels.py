"""The decode kernels: CUDA kernels and their plain versions.

Port of ``ulcx.bitstream.pallas_decode``, and of the record placement
that ``ulcx.bitstream.fast_decode`` does outside its kernels. The state
machine has two modes: ``fsm`` writes the record and code planes (what
ulcx's ``_fsm_kernel`` computes), ``fsm_place`` writes each record's
expansion word at its start position instead (the machine fused with
``records_to_flags``), which is what ``fast_decode.decode_block_fast``
runs. Each kernel has

- a wrapper (``fsm``, ``fsm_place``, ``rng_expand``, ``rng``),
  registered by ``_build.kernel``: on a CPU tensor it runs the plain
  version; on a CUDA tensor it checks dtype, shape and contiguity,
  allocates the outputs and launches its kernel from
  ``csrc/decode_walks.cu`` on the current stream, or raises;
- a plain PyTorch version (``*_plain``) with the same signature: a
  Python loop over tokens or positions, vectorized over streams, on
  whatever device its inputs lie. It is the CPU path, the
  ``use_pallas="off"`` path, and the kernels' oracle on the card.

Layouts: token planes [T, B] and position planes [P, B], stream
fastest; per-stream values [B]. RNG seeds are u32 values held as the
int32 with the same bits; the plain versions step them in int64 masked
to 32 bits, since torch has no logical right shift on int32.

Field maps (any P = n_chan * block_size <= 255 * 32768 < 2^23):
  rec         record start 23 bits | record type << 23 (0 where no record)
  code        level a 5 bits | decay dn << 5 | quantizer qi << 13
  flags       (expansion) start bit 0 | draw record 1 | coded coefficient 2 |
              tail 3 | code << 4, set at record starts only
  rng flags   draw bit 0 | start bit 1, the draw bit filled forward
  syntax word see ``_syntax_words``

CPU tests of this module and of the decode path (from the repo root):
    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_decode_kernels.py tests/test_torch_decode.py -q
On a card, ``python3 chip_smoke.py`` builds the kernels and holds each
against its plain version.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, NamedTuple

import numpy as np
import torch

from ulcx_torch._build import check as _check
from ulcx_torch._build import kernel
from ulcx_torch._build import launch as _launch
from ulcx_torch.bitstream.encode_kernels import STAGES, _arr, _wrap_i32
from ulcx_torch.ops.patterns import pattern_subblock_offsets, pattern_subblock_sizes
from ulcx_torch.ops.quant import expand_quantizer

# FSM modes (the vocabulary of ulcx.bitstream.decode)
M_QUANT_START = 0
M_QUANT_EXT_S = 1
M_NORMAL = 2
M_QUANT_MID = 3
M_QUANT_EXT_M = 4
M_ZSHORT = 5
M_LRUN_Y = 6
M_LRUN_X = 7
M_NOISE_Z = 8
M_NOISE_Y = 9
M_NOISE_X = 10
M_TAIL_Z = 11
M_TAIL_Y = 12
M_TAIL_X = 13
M_DONE = 14
M_CORRUPT = 15

REC_NONE = 0
REC_COEF = 1
REC_ZERO = 2
REC_NOISE = 3
REC_TAIL = 4

REC_START_BITS = 23  # rec holds a record start in 23 bits: P < 2^23
REC_START_MASK = (1 << REC_START_BITS) - 1
# Launch geometry of the RNG kernels (csrc/decode_walks.cu): a CTA walks
# RNG_STREAMS streams, one lane of warp 0 each, while RNG_HELPER_WARPS
# warps fill a ring of STAGES shared-memory stages of RNG_CHUNK
# positions each, run the carry-free pre-pass and store the output.
RNG_STREAMS = 8
RNG_CHUNK = 128
RNG_HELPER_WARPS = 3
# The FSM kernel's: the same CTA over chunks of FSM_CHUNK tokens; the
# helpers build the code words from what the walker staged and store
# them (in the placing mode, scatter the expansion words).
FSM_STREAMS = 8
FSM_CHUNK = 128
FSM_HELPER_WARPS = 3
SEED = 1234567  # the reference's global noise seed (ulcDecoder.c:75-81)
_I32 = torch.int32
_M32 = 0xFFFFFFFF
_FLT_MIN = 2.0**-126


def _next_end_table(block_size: int) -> np.ndarray:
    """[16, 8]: for each pattern and N/8 slot, the in-channel coefficient
    index where the segment holding that slot ends."""
    out = np.zeros((16, 8), np.int32)
    for pat in range(16):
        pi = pat or 1
        for off, ss in zip(
            pattern_subblock_offsets(pi, block_size),
            pattern_subblock_sizes(pi, block_size),
        ):
            s0 = off // (block_size // 8)
            s1 = (off + ss) // (block_size // 8)
            out[pat, s0:s1] = off + ss
    return out


@lru_cache(maxsize=16)
def _next_end_tensor(block_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_next_end_table(block_size)).to(device)


def _ffill(values: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Along dim 0: the value at the last start at or before each
    position, 0 before the first start."""
    pos = torch.arange(values.shape[0], device=values.device)[:, None]
    last = torch.where(start, pos, -1).cummax(dim=0).values
    filled = values.gather(0, last.clamp(min=0))
    return torch.where(last >= 0, filled, torch.zeros_like(filled))


def _xorshift(state: torch.Tensor) -> torch.Tensor:
    """xorshift32(13, 17, 5) on u32 values held in int64."""
    s = state ^ ((state << 13) & _M32)
    s = s ^ (s >> 17)
    return s ^ ((s << 5) & _M32)


def rng_flags(flags: torch.Tensor) -> torch.Tensor:
    """Expansion flags [P, B] -> the unfused RNG kernel's flags: draw bit
    0 (the record's draw bit, filled forward from its start) | start
    bit 1."""
    start = (flags & 1) == 1
    draw = _ffill((flags >> 1) & 1, start)
    return (draw | ((flags & 1) << 1)).to(_I32)


# --- launch geometry --------------------------------------------------------


def rng_smem_bytes(expand: bool, chunk: int, streams: int) -> int:
    """Dynamic shared memory of one RNG CTA: STAGES stages of
    ``rng_layout`` in csrc/decode_walks.cu, which the entry points check
    against this number. A stage holds, per (position, stream), the
    flags, the pre-pass word and the output, and with ``expand`` the
    level and the decay."""
    return STAGES * (5 if expand else 3) * _arr(chunk * streams)


def rng_geometry(n_pos: int, b: int, expand: bool = True, streams: int = RNG_STREAMS,
                 helper_warps: int = RNG_HELPER_WARPS) -> dict:
    """Launch geometry of the RNG kernels at P = n_pos, B = b: streams
    per CTA, chunk length, ring stages, threads and shared-memory bytes
    per CTA, and the grid (CTAs ``rng_tiles``, each walking the chunks
    ``encode_kernels.walk_chunks(n_pos, RNG_CHUNK, False)``)."""
    if n_pos < 1 or b < 1:
        raise ValueError(f"empty walk: P={n_pos}, B={b}")
    if not 1 <= streams <= 32:
        raise ValueError(f"{streams} streams: a CTA walks 1 to 32, one lane of warp 0 each")
    return {
        "streams": streams, "chunk": RNG_CHUNK, "stages": STAGES,
        "threads": 32 * (1 + helper_warps), "smem": rng_smem_bytes(expand, RNG_CHUNK, streams),
        "grid": -(-b // streams),
    }


def rng_tiles(b: int, streams: int = RNG_STREAMS) -> list:
    """[(b0, ns)] streams of each CTA: b0 = blockIdx * streams."""
    return [(b0, min(streams, b - b0)) for b0 in range(0, b, streams)]


def _rng_geometry_ints(n_pos: int, b: int, expand: bool) -> tuple:
    g = rng_geometry(n_pos, b, expand)
    return g["streams"], g["chunk"], g["threads"], g["smem"]


def fsm_smem_bytes(chunk: int, streams: int) -> int:
    """Dynamic shared memory of one FSM CTA: ``fsm_layout`` in
    csrc/decode_walks.cu, which the entry points check against this
    number. The 256 syntax words and the 16 x 8 next-end table, then
    STAGES stages that hold, per (token, stream), the token, the record
    word and the walker's registers."""
    return _arr(256) + _arr(128) + STAGES * 3 * _arr(chunk * streams)


def fsm_geometry(t_len: int, b: int, streams: int = FSM_STREAMS,
                 helper_warps: int = FSM_HELPER_WARPS) -> dict:
    """Launch geometry of the FSM kernel at T = t_len tokens, B = b:
    streams per CTA, chunk length, ring stages, threads and
    shared-memory bytes per CTA, and the grid (CTAs ``rng_tiles(b,
    streams)``, each walking the chunks ``encode_kernels.walk_chunks(
    t_len, FSM_CHUNK, False)`` until every one of its blocks has ended).
    The record mode and the placing mode share it: they differ in what
    the helpers store."""
    if t_len < 0 or b < 1:
        raise ValueError(f"empty walk: T={t_len}, B={b}")
    if not 1 <= streams <= 32:
        raise ValueError(f"{streams} streams: a CTA walks 1 to 32, one lane of warp 0 each")
    return {
        "streams": streams, "chunk": FSM_CHUNK, "stages": STAGES,
        "threads": 32 * (1 + helper_warps), "smem": fsm_smem_bytes(FSM_CHUNK, streams),
        "grid": -(-b // streams),
    }


def _fsm_geometry_ints(t_len: int, b: int) -> tuple:
    g = fsm_geometry(t_len, b)
    return g["streams"], g["chunk"], g["threads"], g["smem"]


# --- plain versions ---------------------------------------------------------


@lru_cache(maxsize=1)
def _syntax_tables() -> dict:
    """The token syntax as [16 modes, 16 nybbles] tables: the next mode
    when the token ends no record (``next``, CORRUPT for a bad token),
    the record it ends (``kind``; a run's record is taken back if the
    run overflows its segment), the quantizer it sets (``qi``, -1 to
    keep), how it loads the run register (``r0``: 1 = x, 2 =
    r0 << 4 | x), and whether it is a run length (``run``). A run is
    ``n0 + r0 * nmul`` positions long (the three run forms: x + 1,
    (r0 << 4 | x) + 33, (r0 << 1 | x & 1) + 16), and a record's level a
    is ``a0``, plus r0 >> 4 in a tail record."""
    x = np.arange(16)
    t = {k: np.zeros((16, 16), np.int64)
         for k in ("next", "kind", "r0", "run", "n0", "nmul", "a0")}
    t["qi"] = np.full((16, 16), -1, np.int64)
    t["next"][:] = np.arange(16)[:, None]  # DONE and CORRUPT stay
    t["next"][M_QUANT_START] = np.where(
        x == 0xF, M_CORRUPT, np.where(x == 0xE, M_QUANT_EXT_S, M_NORMAL))
    t["qi"][M_QUANT_START] = np.where(x < 0xE, x, -1)
    for m in (M_QUANT_EXT_S, M_QUANT_EXT_M):
        t["next"][m] = M_NORMAL
        t["kind"][m] = np.where(x == 0xF, REC_ZERO, REC_NONE)
        t["qi"][m] = np.where(x != 0xF, 0xE + x, -1)
    t["next"][M_QUANT_MID] = np.where(x == 0xF, M_TAIL_Z, np.where(x == 0xE, M_QUANT_EXT_M, M_NORMAL))
    t["qi"][M_QUANT_MID] = np.where(x < 0xE, x, -1)
    t["next"][M_NORMAL] = M_NORMAL
    for tok, m in ((0x0, M_ZSHORT), (0x1, M_LRUN_Y), (0x8, M_NOISE_Z), (0xF, M_QUANT_MID)):
        t["next"][M_NORMAL, tok] = m
    t["kind"][M_NORMAL] = np.where(np.isin(x, (0x0, 0x1, 0x8, 0xF)), REC_NONE, REC_COEF)
    for m, kind in ((M_ZSHORT, REC_ZERO), (M_LRUN_X, REC_ZERO), (M_NOISE_X, REC_NOISE)):
        t["kind"][m] = kind
        t["run"][m] = 1
    t["kind"][M_TAIL_X] = REC_TAIL
    t["n0"][M_ZSHORT] = x + 1
    t["n0"][M_LRUN_X], t["nmul"][M_LRUN_X] = x + 33, 16
    t["n0"][M_NOISE_X], t["nmul"][M_NOISE_X] = (x & 1) + 16, 2
    t["a0"][M_NORMAL] = np.where(t["kind"][M_NORMAL] == REC_COEF, x, 0)
    t["a0"][M_NOISE_X] = (x >> 1) + 1
    t["a0"][M_TAIL_X] = 1
    for m in (M_LRUN_Y, M_NOISE_Z, M_NOISE_Y, M_TAIL_Z, M_TAIL_Y):
        t["next"][m] = m + 1
        t["r0"][m] = 2 if m in (M_NOISE_Y, M_TAIL_Y) else 1
    return {k: v.reshape(-1) for k, v in t.items()}


# field -> (shift, bits) of the kernel's packed syntax word; qi is held
# as qi + 1, 0 to keep
SYNTAX_FIELDS = {"next": (0, 4), "kind": (4, 3), "qi": (8, 5), "r0": (13, 2), "run": (15, 1),
                 "n0": (16, 6), "nmul": (22, 5), "a0": (27, 4)}


def _syntax_words() -> np.ndarray:
    """``_syntax_tables`` as the [256] int32 table the FSM kernel steps
    through: one word per (mode, nybble), fields at ``SYNTAX_FIELDS``."""
    tab = _syntax_tables()
    words = np.zeros(256, np.int64)
    for name, (shift, bits) in SYNTAX_FIELDS.items():
        field = tab[name] + 1 if name == "qi" else tab[name]
        if field.min() < 0 or field.max() >= 1 << bits:
            raise ValueError(f"syntax field {name} does not fit {bits} bits")
        words |= field << shift
    return words.astype(np.int32)


@lru_cache(maxsize=16)
def _syntax_tensor(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_syntax_words()).to(device)


def fsm_plain(wc, tokens, p_tot: int, n: int):
    """Nybble-syntax state machine. wc [B] i32 window control (pattern
    in bits 4-7); tokens [T, B] i32 nybbles after the header. Returns
    (rec [T, B], code [T, B], consumed [B], corrupt [B]), all i32:
    consumed counts the tokens read, including the one that ends the
    block; corrupt is 1 unless the block ended within the tokens.

    A record ends at the segment end (a quantizer stop, a tail), one
    past the coefficient, or after the run; the block ends when a record
    reaches P, and a segment's next token is a quantizer."""
    t_len, b = tokens.shape
    dev = tokens.device
    tab = {k: torch.from_numpy(v).to(dev) for k, v in _syntax_tables().items()}
    nse = _next_end_tensor(n, dev)[((wc >> 4) & 15).long()].long()  # [B, 8]
    slot_shift = int(np.log2(n // 8))
    mode = torch.full((b,), M_QUANT_START, dtype=torch.int64, device=dev)
    pos = torch.zeros_like(mode)
    qi = torch.zeros_like(mode)
    r0 = torch.zeros_like(mode)
    consumed = torch.zeros_like(mode)
    rec = torch.zeros((t_len, b), dtype=_I32, device=dev)
    code = torch.zeros((t_len, b), dtype=_I32, device=dev)
    for t in range(t_len):
        active = mode < M_DONE
        if t % 32 == 0 and not bool(active.any()):
            break  # every block has ended: the rest of the planes stays 0
        x = tokens[t].long()
        idx = mode * 16 + x
        se = (pos & ~(n - 1)) + nse.gather(1, ((pos & (n - 1)) >> slot_shift)[:, None])[:, 0]
        is_run = tab["run"][idx] == 1
        n_run = tab["n0"][idx] + r0 * tab["nmul"][idx]
        run_bad = is_run & (n_run > se - pos)
        kind = torch.where(run_bad, REC_NONE, tab["kind"][idx])
        end = torch.where(is_run, pos + n_run, torch.where(kind == REC_COEF, pos + 1, se))
        seg_adv = torch.where(end >= p_tot, M_DONE, torch.where(end == se, M_QUANT_START, M_NORMAL))
        emit = kind != REC_NONE
        new_m = torch.where(emit, seg_adv, tab["next"][idx])
        new_m = torch.where(run_bad, M_CORRUPT, new_m)
        a = tab["a0"][idx] + torch.where(kind == REC_TAIL, r0 >> 4, 0)
        dn = torch.where(kind == REC_TAIL, ((r0 & 0xF) << 4) | x, 0)
        emit = emit & active
        rec[t] = torch.where(emit, pos | (kind << REC_START_BITS), 0).to(_I32)
        code[t] = torch.where(emit, a | (dn << 5) | (qi << 13), 0).to(_I32)
        r0_op = tab["r0"][idx]
        new_r0 = torch.where(r0_op == 1, x, torch.where(r0_op == 2, ((r0 << 4) | x) & 0xFF, r0))
        new_qi = tab["qi"][idx]
        consumed = consumed + active.long()
        mode = torch.where(active, new_m, mode)
        pos = torch.where(active & emit, end, pos)
        qi = torch.where(active & (new_qi >= 0), new_qi, qi)
        r0 = torch.where(active, new_r0, r0)
    return rec, code, consumed.to(_I32), (mode != M_DONE).to(_I32)


def place_records(rec: torch.Tensor, code: torch.Tensor, p_tot: int) -> torch.Tensor:
    """Records [T, B] -> expansion flags [P, B] i32: each record's packed
    word (start | draw << 1 | coded << 2 | tail << 3 | code << 4) at its
    start position, 0 elsewhere. One scatter into a zeroed plane: starts
    strictly increase within a stream, so no two records share a
    position."""
    b = rec.shape[1]
    rtype = (rec >> REC_START_BITS) & 0x7
    emit = rtype != REC_NONE
    draw = (rtype == REC_NOISE) | (rtype == REC_TAIL)
    meta = torch.where(
        emit,
        1 | (draw.to(_I32) << 1) | ((rtype == REC_COEF).to(_I32) << 2)
        | ((rtype == REC_TAIL).to(_I32) << 3) | (code << 4),
        0,
    ).to(_I32)
    # tokens without a record write 0 into a drop row at P
    row = torch.where(emit, rec & REC_START_MASK, p_tot).long()
    flat = torch.zeros(((p_tot + 1) * b,), dtype=_I32, device=rec.device)
    col = torch.arange(b, device=rec.device)
    flat.scatter_(0, (row * b + col).reshape(-1), meta.reshape(-1))
    return flat[: p_tot * b].reshape(p_tot, b)


def fsm_place_plain(wc, tokens, p_tot: int, n: int):
    """The state machine fused with the record placement: ``fsm_plain``,
    then ``place_records``. Returns (flags [P, B], consumed [B],
    corrupt [B]), all i32. A stream that turns corrupt keeps the records
    it emitted before."""
    rec, code, consumed, corrupt = fsm_plain(wc, tokens, p_tot, n)
    return place_records(rec, code, p_tot), consumed, corrupt


def _levels(flags: torch.Tensor):
    """Per position, from the record codes: (level, decay) f32 as the
    reference rebuilds them (every product exact)."""
    a = (flags >> 4) & 0x1F
    dn = (flags >> 9) & 0xFF
    quant = expand_quantizer((flags >> 17) & 0x1F)
    is_coef = (flags & 4) == 4
    is_tail = (flags & 8) == 8
    s = ((a & 0xF) ^ 0x8) - 0x8
    val_coef = torch.where(s < 0, -(s * s), s * s).to(torch.float32) * quant
    aa = (a * a).to(torch.float32) * quant
    lvl = torch.where(is_coef, val_coef, torch.where(is_tail, aa * 0.0625, aa * 0.25))
    dcy = torch.where(is_tail, 1.0 + (dn * dn).to(torch.float32) * -(2.0**-19), 0.0)
    return lvl, dcy


def rng_expand_plain(flags, seed):
    """Fused noise-RNG replay, record fill and coefficient assembly.
    flags [P, B] i32 (expansion flags); seed [B] i32 (u32 bits).
    Returns (coef [P, B] f32, new seed [B] i32).

    The draw bit, level and decay latch at record starts. At each draw
    position the xorshift32 state steps and its top bit flips the
    record's sign parity (reset at the start); a tail record's
    magnitude then decays by one rounded product, flushed to zero when
    it leaves the normal range, as the TPU and XLA flush denormals."""
    n_pos = flags.shape[0]
    start = (flags & 1) == 1
    lvl_in, dcy_in = _levels(flags)
    lvl = _ffill(lvl_in, start)
    dcy = _ffill(dcy_in, start)
    draw = _ffill((flags >> 1) & 1, start) == 1
    is_coef = (flags & 4) == 4
    state = seed.long() & _M32
    parity = torch.zeros_like(state)
    mag = torch.zeros_like(lvl_in[0])
    coef = torch.empty_like(lvl_in)
    for p in range(n_pos):
        d = draw[p]
        state = torch.where(d, _xorshift(state), state)
        parity = torch.where(start[p], 0, parity)
        parity = torch.where(d, parity ^ ((state >> 31) & 1), parity)
        mag = torch.where(start[p], lvl_in[p], mag)
        signed = torch.where(parity == 1, -mag, mag)
        coef[p] = torch.where(is_coef[p], lvl[p], torch.where(d, signed, 0.0))
        decayed = mag * dcy[p]
        decayed = torch.where(decayed.abs() < _FLT_MIN, decayed * 0.0, decayed)
        mag = torch.where(d & (dcy[p] != 0.0), decayed, mag)
    return coef, _wrap_i32(state)


def rng_plain(flags, seed):
    """Unfused sign replay. flags [P, B] i32 (draw bit 0 | start bit 1,
    see ``rng_flags``); seed [B] i32 (u32 bits). Returns (sign [P, B]
    f32 of +-1, new seed [B] i32)."""
    draw = (flags & 1) == 1
    start = (flags & 2) == 2
    state = seed.long() & _M32
    parity = torch.zeros_like(state)
    sign = torch.empty(flags.shape, dtype=torch.float32, device=flags.device)
    for p in range(flags.shape[0]):
        state = torch.where(draw[p], _xorshift(state), state)
        parity = torch.where(start[p], 0, parity)
        parity = torch.where(draw[p], parity ^ ((state >> 31) & 1), parity)
        sign[p] = torch.where(parity == 1, -1.0, 1.0)
    return sign, _wrap_i32(state)


# --- wrappers ---------------------------------------------------------------


def _fsm_args(wc, tokens, p_tot: int, n: int):
    """Check the FSM kernel's inputs; returns (T, B, the kernel's input
    tensors, consumed, corrupt)."""
    t_len, b = tokens.shape
    _check("wc", wc, _I32, (b,))
    _check("tokens", tokens, _I32, (t_len, b))
    if n < 8 or n & (n - 1) or p_tot < 1:
        raise ValueError(f"block size {n} (a power of two from 8), P = {p_tot}")
    dev = tokens.device
    ins = (wc, tokens, _next_end_tensor(n, dev), _syntax_tensor(dev))
    return (t_len, b, ins, torch.empty((b,), dtype=_I32, device=dev),
            torch.empty((b,), dtype=_I32, device=dev))


@kernel(fsm_plain)
def fsm(wc, tokens, p_tot: int, n: int):
    """Nybble-syntax state machine (replaces pallas_decode._fsm_kernel)
    -> (rec, code, consumed, corrupt); see ``fsm_plain``."""
    t_len, b, ins, consumed, corrupt = _fsm_args(wc, tokens, p_tot, n)
    # the kernel stops at the end of the block: tokens after it stay 0
    rec = torch.zeros((t_len, b), dtype=_I32, device=tokens.device)
    code = torch.zeros((t_len, b), dtype=_I32, device=tokens.device)
    _launch("ulcx_fsm", (*ins, rec, code, consumed, corrupt),
            (b, t_len, p_tot, n, *_fsm_geometry_ints(t_len, b)), tokens.device)
    return rec, code, consumed, corrupt


@kernel(fsm_place_plain)
def fsm_place(wc, tokens, p_tot: int, n: int):
    """The state machine fused with the record placement (replaces
    pallas_decode._fsm_kernel together with fast_decode's
    records_to_flags) -> (flags [P, B], consumed, corrupt); see
    ``fsm_place_plain``."""
    t_len, b, ins, consumed, corrupt = _fsm_args(wc, tokens, p_tot, n)
    # the kernel writes at record starts only
    flags = torch.zeros((p_tot, b), dtype=_I32, device=tokens.device)
    _launch("ulcx_fsm_place", (*ins, flags, consumed, corrupt),
            (b, t_len, p_tot, n, *_fsm_geometry_ints(t_len, b)), tokens.device)
    return flags, consumed, corrupt


def _rng_args(flags, seed):
    """Check the RNG kernels' inputs; returns (P, B, new seed plane)."""
    n_pos, b = flags.shape
    _check("flags", flags, _I32, (n_pos, b))
    _check("seed", seed, _I32, (b,))
    return n_pos, b, torch.empty((b,), dtype=_I32, device=flags.device)


@kernel(rng_expand_plain)
def rng_expand(flags, seed):
    """Fused RNG replay and coefficient assembly (replaces
    pallas_decode._rng_expand_kernel) -> (coef [P, B] f32, new seed)."""
    n_pos, b, seed_out = _rng_args(flags, seed)
    coef = torch.empty((n_pos, b), dtype=torch.float32, device=flags.device)
    _launch("ulcx_rng_expand", (flags, seed, coef, seed_out),
            (b, n_pos, *_rng_geometry_ints(n_pos, b, True)), flags.device)
    return coef, seed_out


@kernel(rng_plain)
def rng(flags, seed):
    """Unfused sign replay (replaces pallas_decode._rng_kernel) ->
    (sign [P, B] f32, new seed)."""
    n_pos, b, seed_out = _rng_args(flags, seed)
    sign = torch.empty((n_pos, b), dtype=torch.float32, device=flags.device)
    _launch("ulcx_rng", (flags, seed, sign, seed_out),
            (b, n_pos, *_rng_geometry_ints(n_pos, b, False)), flags.device)
    return sign, seed_out


class Walks(NamedTuple):
    """One implementation of each decode walk, called alike."""

    fsm: Callable
    fsm_place: Callable
    rng_expand: Callable
    rng: Callable


KERNEL_WALKS = Walks(fsm, fsm_place, rng_expand, rng)  # a CPU tensor runs the plain versions
PLAIN_WALKS = Walks(*(w.plain for w in KERNEL_WALKS))  # on any device
