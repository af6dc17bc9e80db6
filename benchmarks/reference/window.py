"""The encoder's window control (transient detection) in float64, plain
NumPy, after libulc/ulcEncoder_WindowControl.c, vectorised over streams.

Per block the detector reads the M/S'd pair (previous block || new
block) of each stream and decides the window control of the block after
the new one (ULCi_GetWindowCtrl):

1. Two 3-tap filters over every channel, lag N/2: HP ``-z^-1 + 2 - z``,
   BP ``-z^-1 + z``; their energies summed over channels (:31-70).
2. Forward smears (EMAs x[n] = r x[n-1] + (1 - r) v[n]) of the filters'
   magnitudes, then backward smears of those; the error energy
   ``(dHP * EnvBP)^2 + (dBP * EnvHP)^2`` (:72-104).
3. A block-rate EMA of the error, summed into 8 segments; a 16-entry
   buffer keeps the last two blocks' segments (:107-134).
4. The subblock search over segment log-ratios, then the overlap scale
   and the pattern (:140-239).

A stream's first block is coded with the window control 0x10 (one long
subblock, no decimation); block t >= 1 with what the detector gave on
the pair (block t - 2, block t - 1), block -1 being silence.
"""

from __future__ import annotations

import math

import numpy as np

RATE_HP_FWD = float.fromhex("0x1.CC845Cp6")   # -1.0 dB/ms
RATE_BP_FWD = float.fromhex("0x1.596344p8")   # -3.0 dB/ms
RATE_HP_BWD = float.fromhex("0x1.CC845Cp7")   # -2.0 dB/ms
RATE_BP_BWD = float.fromhex("0x1.596344p8")   # -3.0 dB/ms
RATE_BLOCK = float.fromhex("0x1.1AF110p-6")   # -0.00015 dB/ms * BlockSize
MAX_DECIMATION = 8                             # include/ulcEncoder.h:30
LOG2 = math.log(2.0)
TINY = 2.0 ** -149  # float32's least magnitude: the codec's sums below it are 0
CHUNK = 1024  # EMA samples a prefix sum covers: r^-1024 stays under e^14


def ema(v: np.ndarray, r: float, init: np.ndarray, reverse: bool = False) -> np.ndarray:
    """x[n] = r x[n-1] + (1 - r) v[n] along the last axis of [S, L], from
    x[-1] = init [S] (``reverse``: from the end). The inputs here are
    never negative, so the chunked prefix sums lose nothing to
    cancellation."""
    if reverse:
        return ema(v[:, ::-1], r, init)[:, ::-1]
    out = np.empty_like(v)
    k = min(CHUNK, v.shape[1])
    j = np.arange(k)
    up, down = np.power(r, -j), np.power(r, j)
    carry = init.astype(np.float64)
    for a in range(0, v.shape[1], k):
        cs = np.cumsum(v[:, a:a + k] * up, axis=1)
        out[:, a:a + k] = r * down * carry[:, None] + (1.0 - r) * down * cs
        carry = out[:, a + k - 1]
    return out


def _log_ratio(s: np.ndarray, w: np.ndarray) -> np.ndarray:
    """log(s / w), or -100 for a segment with no energy. The codec's
    float32 state holds none where a smear has decayed past float32's
    range (ahead of an onset after silence), so neither does this."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(s >= TINY, np.log(np.maximum(s, TINY) / np.maximum(w, TINY)), -100.0)


class WindowControl:
    """The detector's state for S streams: ``step`` takes each stream's
    next input block and returns the window control of the block after
    it."""

    def __init__(self, streams: int, n: int, rate_hz: int):
        self.n, self.rate_hz = n, rate_hz
        self.prev = np.zeros((streams, 2, n))  # M/S'd previous block
        self.env_hp = np.zeros(streams)
        self.env_bp = np.zeros(streams)
        self.env_block = np.zeros(streams)
        self.seg_sum = np.zeros((streams, 16))
        self.seg_w = np.zeros((streams, 16))

    def _filter(self, new_ms: np.ndarray) -> None:
        n, hz = self.n, self.rate_hz
        q = np.concatenate([self.prev, new_ms], axis=-1)[..., n // 2 - 1: n // 2 + n + 1]
        t0, t1, t2 = q[..., :-2], q[..., 1:-1], q[..., 2:]
        hp = np.sum((2.0 * t1 - t0 - t2) ** 2, axis=1)
        bp = np.sum((t2 - t0) ** 2, axis=1)
        env_hp = ema(np.sqrt(hp), math.exp(-RATE_HP_FWD / hz), self.env_hp)
        env_bp = ema(np.sqrt(bp), math.exp(-RATE_BP_FWD / hz), self.env_bp)
        pre_hp = ema(env_hp, math.exp(-RATE_HP_BWD / hz), env_hp[:, -1], reverse=True)
        pre_bp = ema(env_bp, math.exp(-RATE_BP_BWD / hz), env_bp[:, -1], reverse=True)
        # the change uses the smear of the sample after (the last: its own)
        d_hp = env_hp - np.concatenate([pre_hp[:, 1:], env_hp[:, -1:]], axis=1)
        d_bp = env_bp - np.concatenate([pre_bp[:, 1:], env_bp[:, -1:]], axis=1)
        err = (d_hp * pre_bp) ** 2 + (d_bp * pre_hp) ** 2
        em = ema(err, math.exp(-RATE_BLOCK * n / hz), self.env_block)
        self.env_hp, self.env_bp, self.env_block = env_hp[:, -1], env_bp[:, -1], em[:, -1]
        self.seg_sum = np.concatenate([self.seg_sum[:, 8:], em.reshape(-1, 8, n // 8).sum(axis=2)], axis=1)
        self.seg_w = np.concatenate([self.seg_w[:, 8:], np.full((len(em), 8), float(n // 8))], axis=1)
        self.prev = new_ms

    def step(self, block: np.ndarray) -> np.ndarray:
        """block [S, 2, N] (L, R) -> the window control [S] of the block
        after it."""
        block = block.astype(np.float64)
        self._filter(np.stack([block[:, 0] + block[:, 1], block[:, 0] - block[:, 1]], axis=1) * 0.5)

        n_seg, seg_size = MAX_DECIMATION, 8 // MAX_DECIMATION
        log2_sub = int(math.log2(self.n // MAX_DECIMATION))
        if log2_sub < 6:
            n_seg >>= 6 - log2_sub
            seg_size <<= 6 - log2_sub
            log2_sub = 6
        s = len(self.seg_sum)
        zero = np.zeros((s, 1))
        csum = np.concatenate([zero, np.cumsum(self.seg_sum, axis=1)], axis=1)
        cw = np.concatenate([zero, np.cumsum(self.seg_w, axis=1)], axis=1)
        decim = np.ones(s, np.int64)
        ratio = np.zeros(s)
        final_log2 = np.full(s, log2_sub)
        running = np.ones(s, bool)
        k = 0
        while n_seg >> k >= 1:
            ns, sz = n_seg >> k, seg_size << k
            a = 8 + np.arange(ns) * sz
            r_np = _log_ratio(csum[:, a + sz] - csum[:, a], cw[:, a + sz] - cw[:, a])
            l_np = _log_ratio(csum[:, a] - csum[:, a - sz], cw[:, a] - cw[:, a - sz])
            rat = np.abs(r_np - l_np)
            best, seg = rat.max(axis=1), rat.argmax(axis=1)  # the first maximum
            accept = running & (best - ratio >= LOG2)
            final_log2 = np.where(running, log2_sub + 1 + k, final_log2)
            decim = np.where(accept, ns + seg, decim)
            ratio = np.where(accept, best, ratio)
            running = accept & (ns > 1) & (ratio < LOG2)
            k += 1
        l2 = ratio / LOG2
        scale = np.where(l2 < 0.5, 0, np.where(l2 >= 6.5, 7, np.round(l2))).astype(np.int64)
        scale = np.where(final_log2 - scale < 6, final_log2 - 6, scale)
        wc = scale + 0x8 * (decim != 1) + 0x10 * decim
        return np.where(ratio < LOG2 / 2, 0x10, wc)


def window_controls(pcm: np.ndarray, n_blocks: int, rate_hz: int) -> np.ndarray:
    """[S, n_blocks] window controls of S streams coded from their start,
    block i the PCM pool's block i % L (pcm [S, L, 2, N])."""
    s, pool = pcm.shape[0], pcm.shape[1]
    det = WindowControl(s, pcm.shape[-1], rate_hz)
    out = np.full((s, n_blocks), 0x10, np.int64)
    for i in range(1, n_blocks):
        out[:, i] = det.step(pcm[:, (i - 1) % pool])
    return out
