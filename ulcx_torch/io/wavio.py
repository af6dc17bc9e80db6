"""WAV file I/O with the reference's exact PCM<->float conversions.

A copy of ``ulcx.io.wavio`` on the port's ``native`` and ``miniriff``.

Mirrors tools/WavIO_* of the reference: a RIFF chunk walk for
``fmt ``/``data`` (reference WavIO_Reader.c:48-58), PCM8u/16/24/FLOAT32
converters with the identical scalings and lrintf clamping semantics
(reference WavIO_Helper.c:31-87), zero-padded reads past EOF
(WavIO_Reader.c:115-150), and deferred size patching on write.

A native C++ backend (ulcx_torch.io.native) accelerates bulk conversion when
the shared library is built; this module is the always-available NumPy
path and defines the format contract.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

WAVE_FORMAT_PCM = 1
WAVE_FORMAT_IEEE_FLOAT = 3


@dataclass
class WavInfo:
    rate_hz: int
    n_chan: int
    bits: int
    fmt_tag: int
    n_samples: int  # sample points (frames)


def _pcm24_to_float(raw: np.ndarray) -> np.ndarray:
    b = raw.reshape(-1, 3).astype(np.uint32)
    x = (b[:, 0] << 8) | (b[:, 1] << 16) | (b[:, 2] << 24)
    return (x.view(np.int32).astype(np.float32)) * np.float32(2.0**-31)


def _float_to_pcm24(x: np.ndarray) -> np.ndarray:
    v = np.rint(np.clip(x * np.float32(2.0**23), -0x800000, 0x7FFFFF)).astype(np.int32)
    u = v.astype(np.uint32)
    out = np.empty((v.size, 3), np.uint8)
    out[:, 0] = u & 0xFF
    out[:, 1] = (u >> 8) & 0xFF
    out[:, 2] = (u >> 16) & 0xFF
    return out.reshape(-1)


def raw_to_float(raw: bytes | np.ndarray, bits: int, fmt_tag: int) -> np.ndarray:
    raw = np.frombuffer(raw, np.uint8) if isinstance(raw, (bytes, bytearray)) else raw
    from ulcx_torch.io import native

    got = native.raw_to_float(raw, bits, fmt_tag) if native.available() else None
    if got is not None:
        return got
    if fmt_tag == WAVE_FORMAT_IEEE_FLOAT and bits == 32:
        return raw.view(np.float32).copy()
    if bits == 8:
        return (raw.view(np.int8).astype(np.int32) ^ 0x80).astype(np.int8).astype(
            np.float32
        ) * np.float32(2.0**-7)
    if bits == 16:
        return raw.view("<i2").astype(np.float32) * np.float32(2.0**-15)
    if bits == 24:
        return _pcm24_to_float(raw)
    if bits == 32 and fmt_tag == WAVE_FORMAT_PCM:
        return raw.view("<i4").astype(np.float32) * np.float32(2.0**-31)
    raise ValueError(f"unsupported WAV format: {bits}-bit tag {fmt_tag}")


def float_to_raw(x: np.ndarray, bits: int, fmt_tag: int) -> np.ndarray:
    x = np.asarray(x, np.float32)
    from ulcx_torch.io import native

    got = native.float_to_raw(x, bits, fmt_tag) if native.available() else None
    if got is not None:
        return got
    if fmt_tag == WAVE_FORMAT_IEEE_FLOAT and bits == 32:
        return x.view(np.uint8)
    if bits == 8:
        v = np.rint(np.clip(x * np.float32(2.0**7), -0x80, 0x7F)).astype(np.int8)
        return (v.view(np.uint8) ^ 0x80).view(np.uint8)
    if bits == 16:
        v = np.rint(np.clip(x * np.float32(2.0**15), -0x8000, 0x7FFF)).astype("<i2")
        return v.view(np.uint8)
    if bits == 24:
        return _float_to_pcm24(x)
    raise ValueError(f"unsupported WAV output format: {bits}-bit tag {fmt_tag}")


class WavReader:
    """Streaming WAV reader (frames of interleaved float32)."""

    def __init__(self, path: str):
        from ulcx_torch.io.miniriff import ChunkHandler, ListHandler, ck_read

        self.f = open(path, "rb")
        head = self.f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError("not a RIFF/WAVE file")
        self.f.seek(0)

        state = {"fmt": None, "data_offset": None, "data_size": 0}

        def on_fmt(f, st, fourcc, size):
            st["fmt"] = f.read(size)
            return 1

        def on_data(f, st, fourcc, size):
            # keep only the first data chunk, like the reference reader
            if st["data_offset"] is None:
                st["data_offset"] = f.tell()
                st["data_size"] = size
            return 1

        wave_list = ListHandler(
            b"WAVE",
            ck_handlers=[
                ChunkHandler(b"fmt ", on_fmt),
                ChunkHandler(b"data", on_data),
            ],
            list_handlers=[],
        )
        ck_read(self.f, state, None, [wave_list])
        if state["fmt"] is None or state["data_offset"] is None:
            # streaming writers often leave the RIFF size field zero (or
            # short); the declared-size walk above then finds nothing.
            # Fall back to a flat sibling scan from offset 12 to EOF.
            self.f.seek(0, 2)
            file_end = self.f.tell()
            pos = 12
            while pos + 8 <= file_end:
                self.f.seek(pos)
                fourcc, size = struct.unpack("<4sI", self.f.read(8))
                data_beg = pos + 8
                if size == 0 or data_beg + size > file_end:
                    size = file_end - data_beg  # unpatched streaming writer
                if fourcc == b"fmt " and state["fmt"] is None:
                    on_fmt(self.f, state, fourcc, size)
                elif fourcc == b"data" and state["data_offset"] is None:
                    on_data(self.f, state, fourcc, size)
                pos = data_beg + ((size + 1) & ~1)
        fmt = state["fmt"]
        self.data_offset = state["data_offset"]
        self.data_size = state["data_size"]
        if fmt is None or self.data_offset is None:
            raise ValueError("missing fmt/data chunk")
        tag, nch, rate, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
        if tag == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
            tag = struct.unpack("<H", fmt[24:26])[0]
        self.info = WavInfo(
            rate_hz=rate,
            n_chan=nch,
            bits=bits,
            fmt_tag=tag,
            n_samples=self.data_size // max(1, (bits // 8) * nch),
        )
        self.f.seek(self.data_offset)
        self._frames_read = 0

    def read_frames(self, n: int) -> np.ndarray:
        """Read n frames as float32 [n * n_chan] interleaved, zero-padded."""
        info = self.info
        bpf = (info.bits // 8) * info.n_chan
        avail = max(0, info.n_samples - self._frames_read)
        take = min(n, avail)
        raw = self.f.read(take * bpf)
        self._frames_read += take
        x = raw_to_float(raw, info.bits, info.fmt_tag)
        if take < n:
            x = np.concatenate([x, np.zeros((n - take) * info.n_chan, np.float32)])
        return x

    def int_scale(self) -> float | None:
        """2**-k such that ``read_frames() == read_frames_int() * scale``
        exactly, or None when the source format has no small-integer
        form (PCM24/PCM32/FLOAT32). Lets callers ship 1-2 bytes/sample
        to an accelerator and scale there: int8/int16 -> float32 is
        exact, so the result is bit-identical to read_frames()."""
        info = self.info
        if info.fmt_tag == WAVE_FORMAT_PCM and info.bits == 8:
            return 2.0**-7
        if info.fmt_tag == WAVE_FORMAT_PCM and info.bits == 16:
            return 2.0**-15
        return None

    def read_frames_int(self, n: int) -> np.ndarray:
        """Read n frames as int8 (PCM8) / int16 (PCM16) [n * n_chan]
        interleaved, zero-padded. Only valid when int_scale() is not
        None. PCM8 is stored unsigned-offset-128; the xor recenters it
        (reference WavIO_Helper.c PCM8u convention)."""
        info = self.info
        bpf = (info.bits // 8) * info.n_chan
        avail = max(0, info.n_samples - self._frames_read)
        take = min(n, avail)
        raw = np.frombuffer(self.f.read(take * bpf), np.uint8)
        self._frames_read += take
        if info.bits == 8:
            x = (raw ^ np.uint8(0x80)).view(np.int8)
        else:
            x = raw.view("<i2")
        if take < n:
            x = np.concatenate([x, np.zeros((n - take) * info.n_chan, x.dtype)])
        return x

    def close(self):
        self.f.close()


class WavWriter:
    def __init__(self, path: str, rate_hz: int, n_chan: int, bits: int, fmt_tag: int):
        self.f = open(path, "wb")
        self.rate = rate_hz
        self.n_chan = n_chan
        self.bits = bits
        self.fmt_tag = fmt_tag
        self.data_bytes = 0
        bypf = bits // 8
        self.f.write(b"RIFF\x00\x00\x00\x00WAVE")
        self.f.write(
            struct.pack(
                "<4sIHHIIHH",
                b"fmt ",
                16,
                fmt_tag,
                n_chan,
                rate_hz,
                bypf * n_chan * rate_hz,
                bypf * n_chan,
                bits,
            )
        )
        self.f.write(struct.pack("<4sI", b"data", 0))

    def write_frames(self, x: np.ndarray):
        raw = float_to_raw(np.asarray(x, np.float32).reshape(-1), self.bits, self.fmt_tag)
        self.f.write(raw.tobytes())
        self.data_bytes += raw.size

    def write_frames_int(self, x: np.ndarray):
        """Write pre-converted integer samples (int8 for PCM8, int16
        for PCM16) — the caller did the scale/clamp/rint, e.g. on an
        accelerator. PCM8 recenters to the stored unsigned-offset-128
        form here."""
        x = np.ascontiguousarray(x).reshape(-1)
        if self.bits == 8:
            raw = x.view(np.uint8) ^ np.uint8(0x80)
        elif self.bits == 16:
            raw = x.astype("<i2", copy=False).view(np.uint8)
        else:
            raise ValueError("write_frames_int: only PCM8/PCM16")
        self.f.write(raw.tobytes())
        self.data_bytes += raw.size

    def close(self):
        end = self.f.tell()
        self.f.seek(4)
        self.f.write(struct.pack("<I", end - 8))
        self.f.seek(12 + 8 + 16 + 4)
        self.f.write(struct.pack("<I", self.data_bytes))
        self.f.close()
