"""The ULC lapped transform in float64, plain NumPy.

The bitstream defines the inverse transform (FormatSpecs.md:148-155):
    y[n] = -sum_k X[k] cos(pi/S (n + 1/2 + S/2)(k + 1/2)),  n < 2S,
and the encoder's forward transform is its match with the encoder-side
2/S normalization (ulcEncoder_BlockTransform.c:243):
    X[k] = -(2/S) sum_n z[n] cos(pi/S (n + 1/2 + S/2)(k + 1/2)).
Both are evaluated here through one complex FFT of length 2S, exact to
float64 rounding. Window switching follows FormatSpecs.md:30-55: the
window control's pattern splits a block into subblocks, and each
boundary's sine overlap is the later subblock's nominal overlap clamped
by the earlier subblock's size.
"""

from __future__ import annotations

import numpy as np

# FormatSpecs.md's window table, packed 4 bits a subblock, first subblock
# lowest: bits 0..2 the size shift, bit 3 the transient flag.
PATTERNS = (
    0x0008, 0x0008, 0x0019, 0x0091, 0x012A, 0x01A2, 0x02A1, 0x0A21,
    0x123B, 0x12B3, 0x1332 | 0x0080, 0x1332 | 0x0800, 0x2331 | 0x0080, 0x2331 | 0x0800,
    0x3321 | 0x0800, 0x3321 | 0x8000,
)


def subblocks(wc: int, n: int) -> list[tuple[int, int, bool]]:
    """[(offset, size, transient flag)] of window control ``wc``'s pattern."""
    pat = PATTERNS[wc >> 4]
    out, off = [], 0
    while pat:
        size = n >> (pat & 0x7)
        out.append((off, size, bool(pat & 0x8)))
        off += size
        pat >>= 4
    return out


def nominal_overlap(size: int, transient: bool, wc: int) -> int:
    """A subblock's overlap into the boundary before it, before the clamp."""
    return size >> (wc & 0x7) if transient else size


def first_overlap(wc: int, n: int) -> int:
    _, size, flag = subblocks(wc, n)[0]
    return nominal_overlap(size, flag, wc)


def last_size(wc: int, n: int) -> int:
    return subblocks(wc, n)[-1][1]


def sine_window(s: int, o_left: int, o_right: int) -> np.ndarray:
    """[2s] window: a sine rise over ``o_left`` samples centred at s/2, a
    mirrored fall over ``o_right`` centred at 3s/2 (0: a step)."""
    def rise(o):
        j = np.arange(s)
        start = s // 2 - o // 2
        t = np.clip((j - start + 0.5) / max(o, 1), 0.0, 1.0)
        return np.where(j < start, 0.0, np.where(j >= start + o, 1.0, np.sin(np.pi / 2 * t)))

    return np.concatenate([rise(o_left), rise(o_right)[::-1]])


def mdct(z: np.ndarray) -> np.ndarray:
    """[..., 2S] windowed frames -> [..., S] coefficients (2/S normalized)."""
    s = z.shape[-1] // 2
    n = np.arange(2 * s)
    k = np.arange(s)
    f = np.fft.fft(z * np.exp(-1j * np.pi * n / (2 * s)), axis=-1)[..., :s]
    n0 = 0.5 + s / 2
    return -(2.0 / s) * np.real(np.exp(-1j * np.pi * n0 * (k + 0.5) / s) * f)


def imdct(x: np.ndarray) -> np.ndarray:
    """[..., S] coefficients -> [..., 2S] unwindowed output."""
    s = x.shape[-1]
    n = np.arange(2 * s)
    k = np.arange(s)
    n0 = 0.5 + s / 2
    pad = np.zeros(x.shape[:-1] + (2 * s,), np.complex128)
    pad[..., :s] = x * np.exp(-1j * np.pi * k * n0 / s)
    return -np.real(np.exp(-1j * np.pi * (n + n0) / (2 * s)) * np.fft.fft(pad, axis=-1))


def mid_side(x: np.ndarray) -> np.ndarray:
    """Pairwise M/S over axis -2: (a, b) -> ((a+b)/2, (a-b)/2)."""
    out = np.array(x, np.float64)
    for c in range(1, x.shape[-2], 2):
        a, b = x[..., c - 1, :], x[..., c, :]
        out[..., c - 1, :], out[..., c, :] = (a + b) * 0.5, (a - b) * 0.5
    return out


def inverse_mid_side(x: np.ndarray) -> np.ndarray:
    out = np.array(x, np.float64)
    for c in range(1, x.shape[-2], 2):
        m, s = x[..., c - 1, :], x[..., c, :]
        out[..., c - 1, :], out[..., c, :] = m + s, m - s
    return out


def block_coefficients(prev: np.ndarray, new: np.ndarray, wc_prev: int | None, wc: int,
                       wc_next: int) -> np.ndarray:
    """The encoder's coefficients of one block: prev, new [C, N] PCM of
    the previous and this block (not yet M/S'd), the window controls of
    the previous (None at a stream's start), this and the next block.
    Returns [C, N] float64."""
    c, n = new.shape
    samples = mid_side(np.concatenate([prev, new], axis=-1))
    subs = subblocks(wc, n)
    o_l = min(first_overlap(wc, n), n if wc_prev is None else last_size(wc_prev, n))
    out = np.zeros((c, n))
    for i, (off, size, _) in enumerate(subs):
        if i + 1 < len(subs):
            _, nsize, nflag = subs[i + 1]
            o_r = min(nominal_overlap(nsize, nflag, wc), size)
        else:
            o_r = min(first_overlap(wc_next, n), size)
        a = n // 2 + off - size // 2
        out[:, off:off + size] = mdct(samples[:, a:a + 2 * size] * sine_window(size, o_l, o_r))
        o_l = o_r
    return out


def synthesize(coefs: np.ndarray, wcs: list[int]) -> np.ndarray:
    """The decoder's PCM of T blocks from a stream's start: coefs
    [T, C, N], wcs their window controls. Returns [T, C, N] float64, M/S
    undone; block t holds the first half of its own synthesis lapped
    with the second half of block t-1's (the codec's one-block delay)."""
    t_blocks, c, n = coefs.shape
    out = np.zeros((c, (t_blocks + 2) * n))
    flat = [(t, off, size, nominal_overlap(size, flag, wcs[t]))
            for t in range(t_blocks) for off, size, flag in subblocks(wcs[t], n)]
    last = 0  # no subblock before a stream's first: a step window
    for i, (t, off, size, nom) in enumerate(flat):
        o_l = min(nom, last)
        o_r = min(flat[i + 1][3], size) if i + 1 < len(flat) else size
        y = imdct(coefs[t, :, off:off + size].astype(np.float64)) * sine_window(size, o_l, o_r)
        a = t * n + n // 2 + off - size // 2
        out[:, a:a + 2 * size] += y
        last = size
    pcm = out[:, : t_blocks * n].reshape(c, t_blocks, n).transpose(1, 0, 2)
    return inverse_mid_side(pcm)
