"""Codec configuration.

The port's own copy of ``ulcx.utils.config``: the same dataclass, fields,
defaults, checks and derived properties, so that one set of keyword
arguments configures both packages alike, and the port serves every
setting it admits.

The reference's only configuration is three compile-time feature flags
(reference include/ulcEncoder.h:9-33: ULC_USE_PSYCHOACOUSTICS,
ULC_USE_NOISE_CODING, ULC_USE_WINDOW_SWITCHING) plus the CLI parameters
(rate mode, block size, output PCM format); here they are one runtime
dataclass.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

MIN_CHANS = 1
MAX_CHANS = 255
MIN_BANDS = 256          # reference libulc/ulcEncoder.c:20 (transient detector limit)
MAX_BANDS = 32768
MAX_BLOCK_DECIMATION_FACTOR = 8   # reference include/ulcEncoder.h:30
MAX_SUBBLOCKS = 4
COEF_EPS = 2.0 ** -31    # reference include/ulcEncoder.h:36

N_BARK_BANDS = 25


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Static codec parameters shared by encoder and decoder.

    Mirrors the reference's ULC_EncoderState_t globals (RateHz, nChan,
    BlockSize; reference include/ulcEncoder.h:47-52) plus the three
    feature flags as runtime switches.
    """

    rate_hz: int = 44100
    n_chan: int = 2
    block_size: int = 2048
    use_psychoacoustics: bool = True
    use_noise_coding: bool = True
    use_window_switching: bool = True
    # Transform backend: "matmul" (cosine-matrix products; an explicit
    # "matmul" is taken at any size), "fact" (DCT-IV factorized into two
    # small matmul stages), "fft" (one 2N complex FFT), or "auto" (matmul
    # for subblocks up to matmul_max_n, fact above).
    transform_backend: str = "auto"
    matmul_max_n: int = 2048
    # CBR/ABR rate search: "ladder" (candidates per round, exact under
    # monotone Size(n)) or "bisect" (the reference's sequential
    # bisection, one count a round).
    rate_search: str = "ladder"
    # Noise-run amplitude window: "segment" (min(seg_end - pos, 527)
    # lines, candidate-independent) or "gap" (the reference's exact
    # min(gap_len, 527) per candidate; no kernel has it, so its emission
    # walks run their plain versions, and "on" refuses it as in ulcx).
    noise_run_window: str = "segment"
    # Bitstream walks: "auto" and "on" both mean the kernels in the port,
    # at every P; "off" runs their plain PyTorch versions on whatever
    # device the tensors lie (the port's oracle path, slow on a card).
    use_pallas: str = "auto"
    # Fold the block axis T into the batch: only window control loops
    # over blocks, everything else runs once over B*T streams. Window
    # control is that of the per-block loop; bytes and sizes may differ
    # at float near-ties where the transform products sum in an order
    # that depends on the batch (a card's GEMM).
    flat_stream: bool = False
    # Run the bitstream stages once per chunk of this many blocks, at
    # fold * B streams (when T is a multiple of it; else per block).
    # Byte-identical to the per-block loop. The walk state planes grow
    # with it: 32 * P * B * fold bytes each.
    fold_bitstream: int = 1

    def __post_init__(self):
        if not (MIN_CHANS <= self.n_chan <= MAX_CHANS):
            raise ValueError(f"n_chan must be in [{MIN_CHANS},{MAX_CHANS}], got {self.n_chan}")
        bs = self.block_size
        if not (MIN_BANDS <= bs <= MAX_BANDS) or (bs & (bs - 1)) != 0:
            raise ValueError(f"block_size must be a power of 2 in [{MIN_BANDS},{MAX_BANDS}], got {bs}")
        if self.rate_hz < 1:
            raise ValueError(f"rate_hz must be >= 1, got {self.rate_hz}")
        if self.transform_backend not in ("auto", "matmul", "fact", "fft"):
            raise ValueError(f"bad transform_backend {self.transform_backend!r}")
        if self.rate_search not in ("ladder", "bisect"):
            raise ValueError(f"bad rate_search {self.rate_search!r}")
        if self.noise_run_window not in ("segment", "gap"):
            raise ValueError(f"bad noise_run_window {self.noise_run_window!r}")
        if self.use_pallas not in ("auto", "on", "off"):
            raise ValueError(f"bad use_pallas {self.use_pallas!r}")
        if self.noise_run_window == "gap" and self.use_pallas == "on":
            raise ValueError(
                "noise_run_window='gap' is scan-only (the C-exact run "
                "window is candidate-dependent state the streaming "
                "kernels cannot address); use use_pallas='auto'/'off' "
                "with it, or the default 'segment' window for the fast "
                "path (corpus impact <= 0.114% size, PARITY.md §2)"
            )
        if not (isinstance(self.fold_bitstream, int) and self.fold_bitstream >= 1):
            raise ValueError(
                f"fold_bitstream must be an int >= 1, got {self.fold_bitstream!r}"
            )

    @cached_property
    def max_decimation(self) -> int:
        return MAX_BLOCK_DECIMATION_FACTOR if self.use_window_switching else 1

    @cached_property
    def subblock_sizes(self) -> tuple[int, ...]:
        """All possible subblock sizes (block_size >> {0,1,2,3})."""
        if not self.use_window_switching:
            return (self.block_size,)
        return tuple(self.block_size >> s for s in range(4))

    def transform_for(self, n: int) -> str:
        """Backend name for a length-n DCT-IV/DST-IV."""
        if self.transform_backend != "auto":
            return self.transform_backend
        return "matmul" if n <= self.matmul_max_n else "fact"
