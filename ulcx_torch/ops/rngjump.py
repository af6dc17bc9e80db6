"""xorshift32 jump-ahead over GF(2).

Port of ``ulcx.ops.rngjump``. The decoder's noise RNG (xorshift32 with
shifts 13, 17, 5; seed 1234567 at a stream's start, never reset,
reference ulcDecoder.c:75-81) is a linear map M over GF(2)^32, so
stepping a state k times multiplies it by M^k. That is what lets the
single-stream decoder expand all its blocks at once
(``codec.decoder.decode_stream_pipelined``): the draw counts of the
blocks before give each block its exact entry state.

The matrices M^(2^j), j < 32, come from a copy of ulcx's numpy code
(``_jump_tables``). ``jump`` takes the count four bits at a time: for
each of its eight nybbles m and values v, M^(v * 16^m) is tabled as
eight 16-entry lookup tables, one per nybble of the state (its image is
the XOR of the eight looked-up words). One jump is then eight rounds of
a gather and an XOR fold over the whole batch, about 70 tensor ops,
whatever the counts. Seeds are int32 tensors holding the u32 bits, and
the states step in int64 masked to 32 bits, as in
``bitstream.decode_kernels``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _step(x: np.uint64) -> np.uint64:
    x = (x ^ (x << np.uint64(13))) & np.uint64(0xFFFFFFFF)
    x = x ^ (x >> np.uint64(17))
    return (x ^ (x << np.uint64(5))) & np.uint64(0xFFFFFFFF)


@lru_cache(maxsize=1)
def _jump_tables() -> np.ndarray:
    """[32, 32] uint32: table[j][i] = column i of M^(2^j) (the image of
    basis vector e_i), with vectors packed as uint32."""
    cols = np.array(
        [_step(np.uint64(1) << np.uint64(i)) for i in range(32)], np.uint64
    )

    def matmat(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        out = np.zeros(32, np.uint64)
        for i in range(32):
            v = int(b[i])
            r = 0
            for j in range(32):
                if (v >> j) & 1:
                    r ^= int(a[j])
            out[i] = r
        return out

    mats = [cols]
    for _ in range(31):
        mats.append(matmat(mats[-1], mats[-1]))
    return np.stack(mats).astype(np.uint32)


def _apply(cols: list, v: int) -> int:
    """The matrix with columns ``cols`` times the packed vector ``v``."""
    r = 0
    for i in range(32):
        if (v >> i) & 1:
            r ^= cols[i]
    return r


def _mul(a: list, b: list) -> list:
    """Columns of A * B from the columns of A and of B."""
    return [_apply(a, c) for c in b]


@lru_cache(maxsize=1)
def _nybble_tables() -> np.ndarray:
    """[8, 16, 8, 16] int64: entry [m, v, k, x] is M^(v * 16^m) applied
    to the state nybble x at nybble k (x << 4k), so that M^(v * 16^m) s
    is the XOR over k of entry [m, v, k, (s >> 4k) & 15]."""
    tab = [[int(c) for c in cols] for cols in _jump_tables()]
    eye = [1 << i for i in range(32)]
    out = np.zeros((8, 16, 8, 16), np.int64)
    for m in range(8):
        mat = eye  # v = 0
        for v in range(16):
            if v:  # M^(v * 16^m) = M^(16^m) M^((v - 1) * 16^m), M^(16^m) = M^(2^(4m))
                mat = _mul(tab[4 * m], mat)
            for k in range(8):
                for x in range(16):
                    out[m, v, k, x] = _apply(mat, x << (4 * k))
    return out


@lru_cache(maxsize=8)
def _tables_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_nybble_tables().reshape(-1)).to(device)


def jump(seed: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """seed [...] int32 (u32 bits), count [...] integer >= 0 -> the seed
    stepped ``count`` times (elementwise, exact; count taken modulo
    2^32, as ulcx's uint32 cast takes it), int32 holding the u32 bits."""
    tab = _tables_on(seed.device)
    s = seed.to(torch.int64) & _M32
    c = torch.as_tensor(count, device=seed.device).to(torch.int64).expand_as(s) & _M32
    nyb_shift = torch.arange(0, 32, 4, device=seed.device)  # [8]
    nyb_base = torch.arange(8, device=seed.device) * 16
    for m in range(8):
        v = (c >> (4 * m)) & 15
        idx = ((m * 16 + v) * 128)[..., None] + nyb_base + ((s[..., None] >> nyb_shift) & 15)
        t = tab[idx]  # [..., 8]
        t = t[..., :4] ^ t[..., 4:]
        t = t[..., :2] ^ t[..., 2:]
        s = t[..., 0] ^ t[..., 1]
    return torch.where(s >= 2**31, s - 2**32, s).to(torch.int32)
