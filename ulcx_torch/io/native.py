"""ctypes binding for the native I/O runtime (native/libulcio.so).

A copy of ``ulcx.io.native``: the port imports nothing of ``ulcx``.

Falls back transparently to the NumPy implementations in
``ulcx_torch.io.wavio`` when the shared library hasn't been built
(``make -C native``). The conversions are bit-identical either way
(same scalings and rounding as reference tools/WavIO_Helper.c).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native",
        "libulcio.so",
    )
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        _LIB = False
        return False
    u8 = ctypes.POINTER(ctypes.c_uint8)
    i16 = ctypes.POINTER(ctypes.c_int16)
    i32 = ctypes.POINTER(ctypes.c_int32)
    f32 = ctypes.POINTER(ctypes.c_float)
    i64 = ctypes.c_int64
    for name, args in [
        ("ulcio_pcm8_to_f32", (u8, f32, i64)),
        ("ulcio_pcm16_to_f32", (i16, f32, i64)),
        ("ulcio_pcm24_to_f32", (u8, f32, i64)),
        ("ulcio_pcm32_to_f32", (i32, f32, i64)),
        ("ulcio_f32_to_pcm8", (f32, u8, i64)),
        ("ulcio_f32_to_pcm16", (f32, i16, i64)),
        ("ulcio_f32_to_pcm24", (f32, u8, i64)),
        ("ulcio_deinterleave", (f32, f32, i64, ctypes.c_int)),
        ("ulcio_interleave", (f32, f32, i64, ctypes.c_int)),
        ("ulcio_pack_blocks", (u8, i32, i64, i64, u8)),
    ]:
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = i64 if name == "ulcio_pack_blocks" else None
    _LIB = lib
    return lib


def available() -> bool:
    return bool(_load())


def _ptr(a, ct):
    return a.ctypes.data_as(ct)


def raw_to_float(raw: np.ndarray, bits: int, fmt_tag: int):
    """Native-accelerated raw_to_float; returns None if unsupported."""
    lib = _load()
    if not lib:
        return None
    raw = np.ascontiguousarray(raw)
    if fmt_tag == 3 and bits == 32:
        return raw.view(np.float32).copy()
    if bits == 8:
        out = np.empty(raw.size, np.float32)
        lib.ulcio_pcm8_to_f32(
            _ptr(raw, ctypes.POINTER(ctypes.c_uint8)),
            _ptr(out, ctypes.POINTER(ctypes.c_float)),
            out.size,
        )
        return out
    if bits == 16:
        src = raw.view("<i2")
        out = np.empty(src.size, np.float32)
        lib.ulcio_pcm16_to_f32(
            _ptr(src, ctypes.POINTER(ctypes.c_int16)),
            _ptr(out, ctypes.POINTER(ctypes.c_float)),
            out.size,
        )
        return out
    if bits == 24:
        out = np.empty(raw.size // 3, np.float32)
        lib.ulcio_pcm24_to_f32(
            _ptr(raw, ctypes.POINTER(ctypes.c_uint8)),
            _ptr(out, ctypes.POINTER(ctypes.c_float)),
            out.size,
        )
        return out
    if bits == 32 and fmt_tag == 1:
        src = raw.view("<i4")
        out = np.empty(src.size, np.float32)
        lib.ulcio_pcm32_to_f32(
            _ptr(src, ctypes.POINTER(ctypes.c_int32)),
            _ptr(out, ctypes.POINTER(ctypes.c_float)),
            out.size,
        )
        return out
    return None


def float_to_raw(x: np.ndarray, bits: int, fmt_tag: int):
    lib = _load()
    if not lib:
        return None
    x = np.ascontiguousarray(x, np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    if fmt_tag == 3 and bits == 32:
        return x.view(np.uint8)
    if bits == 8:
        out = np.empty(x.size, np.uint8)
        lib.ulcio_f32_to_pcm8(_ptr(x, f32p), _ptr(out, ctypes.POINTER(ctypes.c_uint8)), x.size)
        return out
    if bits == 16:
        out = np.empty(x.size, np.int16)
        lib.ulcio_f32_to_pcm16(_ptr(x, f32p), _ptr(out, ctypes.POINTER(ctypes.c_int16)), x.size)
        return out.view(np.uint8)
    if bits == 24:
        out = np.empty(x.size * 3, np.uint8)
        lib.ulcio_f32_to_pcm24(_ptr(x, f32p), _ptr(out, ctypes.POINTER(ctypes.c_uint8)), x.size)
        return out
    return None


def pack_blocks(data: np.ndarray, sizes_bits: np.ndarray) -> bytes | None:
    """Assemble [T, stride] encoded rows into a contiguous stream."""
    lib = _load()
    if not lib:
        return None
    data = np.ascontiguousarray(data, np.uint8)
    sizes = np.ascontiguousarray(sizes_bits, np.int32)
    out = np.empty(data.size, np.uint8)
    n = lib.ulcio_pack_blocks(
        _ptr(data, ctypes.POINTER(ctypes.c_uint8)),
        _ptr(sizes, ctypes.POINTER(ctypes.c_int32)),
        sizes.size,
        data.shape[1],
        _ptr(out, ctypes.POINTER(ctypes.c_uint8)),
    )
    return out[:n].tobytes()
