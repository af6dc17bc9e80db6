"""Recursive RIFF/LIST chunk dispatcher (reference tools/MiniRIFF.c).

A copy of ``ulcx.io.miniriff``: the port imports nothing of ``ulcx``.

Same contract as the C reference: `ck_read` reads one chunk at the
current file position; RIFF/LIST chunks look up their list-type in the
handler table and recurse over their children between begin/end
callbacks, other chunks dispatch on FourCC; chunk payloads are 2-byte
aligned (MiniRIFF.c:14-16); a handler returning a negative value stops
list traversal (MiniRIFF.c:29-37); unhandled chunks return 0 and are
skipped (include/MiniRIFF.h:54-59).
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Callable, NamedTuple, Optional, Sequence


class ChunkHandler(NamedTuple):
    fourcc: bytes                       # e.g. b"fmt "
    func: Callable                      # (f, user, fourcc, size) -> int


class ListHandler(NamedTuple):
    fourcc: bytes                       # list type, e.g. b"WAVE"
    ck_handlers: Sequence["ChunkHandler"] | None
    list_handlers: Sequence["ListHandler"] | None
    on_begin: Optional[Callable] = None  # (f, user) -> int
    on_end: Optional[Callable] = None    # (f, user) -> int


def ck_read(f: BinaryIO, user, ck_handlers, list_handlers) -> int:
    """Read one chunk at the current position and dispatch. Returns the
    last handler's value (0 if none matched); always leaves the file
    positioned at the next sibling chunk."""
    hdr = f.read(8)
    if len(hdr) < 8:
        return -1
    fourcc, size = struct.unpack("<4sI", hdr)
    data_beg = f.tell()
    data_end = data_beg + ((size + 1) & ~1)

    ret = 0
    if fourcc in (b"RIFF", b"LIST"):
        if list_handlers:
            (list_type,) = struct.unpack("<4s", f.read(4))
            for lh in list_handlers:
                if lh.fourcc != list_type:
                    continue
                if lh.on_begin:
                    ret = lh.on_begin(f, user)
                    if ret < 0:
                        break
                while f.tell() < data_end:
                    ret = ck_read(f, user, lh.ck_handlers, lh.list_handlers)
                    if ret < 0:
                        break
                if ret >= 0 and lh.on_end:
                    ret = lh.on_end(f, user)
                break
    elif ck_handlers:
        for ch in ck_handlers:
            if ch.fourcc == fourcc:
                ret = ch.func(f, user, fourcc, size)
                break

    f.seek(data_end)
    return ret
