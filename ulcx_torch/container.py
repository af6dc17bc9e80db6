"""ULC2 container (24-byte header + raw block stream).

Port of ``ulcx.container`` (a copy: the port imports nothing of ``ulcx``).
Byte-compatible with the reference tools' FileHeader_t
(tools/ulc_Helper.h:10-20): files produced here decode with the C
``ulcdecodetool`` and vice versa.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

MAGIC = 0x32434C55  # 'ULC2' little-endian
_FMT = "<IHHIIHHI"
HEADER_SIZE = struct.calcsize(_FMT)
assert HEADER_SIZE == 24


@dataclass
class UlcHeader:
    block_size: int
    max_block_size: int  # bytes; 0 = unknown
    n_blocks: int
    rate_hz: int
    n_chan: int
    rate_kbps: int
    stream_offs: int = HEADER_SIZE

    def pack(self) -> bytes:
        return struct.pack(
            _FMT,
            MAGIC,
            self.block_size,
            self.max_block_size,
            self.n_blocks,
            self.rate_hz,
            self.n_chan,
            self.rate_kbps,
            self.stream_offs,
        )

    @staticmethod
    def unpack(data: bytes) -> "UlcHeader":
        if len(data) < HEADER_SIZE:
            raise ValueError("not a ULC2 container")
        magic, bs, mbs, nblk, rate, nch, kbps, offs = struct.unpack(
            _FMT, data[:HEADER_SIZE]
        )
        if magic != MAGIC:
            raise ValueError("not a ULC2 container")
        return UlcHeader(
            block_size=bs,
            max_block_size=mbs,
            n_blocks=nblk,
            rate_hz=rate,
            n_chan=nch,
            rate_kbps=kbps,
            stream_offs=offs,
        )
