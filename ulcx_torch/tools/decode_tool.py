"""ulcdecodetool — CLI decoder, flag-compatible with the reference tool.

Port of ``ulcx.tools.decode_tool``, on the card:

    python -m ulcx_torch.tools.decode_tool Input.ulc Output.wav [-format:PCM8|PCM16|PCM24|FLOAT32]

Usage (reference tools/ulcDecodeTool.c:31-65); ``-chunk:64`` (blocks a
call) and ``-profile:DIR`` (a torch.profiler trace) as in ulcx. On the
card it decodes with ``decode_stream_pipelined`` (only the state machine
serial) unless ``use_pallas="off"`` or P > 32768, as ulcx's tool chooses,
else and on the CPU with ``decode_stream``. PCM8/PCM16 are converted on
the device (``pcm_to_int``). ``main(argv, device="cpu")`` decodes on the
CPU (the tests).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ulcx_torch._build import kernels_on
from ulcx_torch.container import UlcHeader
from ulcx_torch.io.wavio import WAVE_FORMAT_IEEE_FLOAT, WAVE_FORMAT_PCM, WavWriter
from ulcx_torch.utils.config import CodecConfig
from ulcx_torch.utils.device import on_device
from ulcx_torch.utils.profiling import device_trace

_FORMATS = {
    "PCM8": (8, WAVE_FORMAT_PCM),
    "PCM16": (16, WAVE_FORMAT_PCM),
    "PCM24": (24, WAVE_FORMAT_PCM),
    "FLOAT32": (32, WAVE_FORMAT_IEEE_FLOAT),
}
_INT_PCM = {8: (torch.int8, 127.0), 16: (torch.int16, 32767.0)}


def pcm_to_int(pcm: torch.Tensor, bits: int) -> torch.Tensor:
    """PCM8/PCM16 samples of float PCM where it lies: scale by 2^(bits-1),
    clamp to the integer range, round half to even (the host converters'
    lrintf, ``io.wavio.float_to_raw``), as int8/int16."""
    dtype, hi = _INT_PCM[bits]
    return torch.round(torch.clamp(pcm * float(hi + 1), -(hi + 1), hi)).to(dtype)


def main(argv=None, device="cuda") -> int:
    argv = sys.argv if argv is None else argv
    if len(argv) < 3:
        print(
            "ulcDecodeTool - Ultra-Low Complexity Codec Decoding Tool (ulcx)\n"
            "Usage: ulcdecodetool Input.ulc Output.wav [Opt]\n"
            "Options:\n"
            " -format:PCM16 - Set output format (PCM8, PCM16, PCM24, FLOAT32).\n"
        )
        return 1

    fmt = "PCM16"
    chunk = 64
    profile_dir = None
    for a in argv[3:]:
        if a.startswith("-format:"):
            cand = a[len("-format:") :].upper()
            if cand not in _FORMATS:
                print(f"ERROR: Ignoring invalid output format ({cand}).")
                return -1
            fmt = cand
        elif a.startswith("-chunk:"):
            chunk = max(1, int(a[len("-chunk:") :]))
        elif a.startswith("-profile:"):
            profile_dir = a[len("-profile:") :]
        else:
            print(f"WARNING: Ignoring unknown argument ({a}).")
    bits, tag = _FORMATS[fmt]

    from ulcx_torch.codec.decoder import decode_stream, decode_stream_pipelined

    try:
        with open(argv[1], "rb") as f:
            raw = f.read()
        hdr = UlcHeader.unpack(raw)
    except (OSError, ValueError) as e:
        print(f"ERROR: Input file is not a valid ULC container ({e}).")
        return -1

    cfg = CodecConfig(rate_hz=hdr.rate_hz, n_chan=hdr.n_chan, block_size=hdr.block_size)
    window = max(hdr.max_block_size, 16)
    window = -(-window // 64) * 64  # round up for tidy slices
    stream = np.frombuffer(raw[hdr.stream_offs :], np.uint8)
    stream = on_device(np.concatenate([stream, np.zeros(window + 64, np.uint8)]), device)
    # ulcx's choice of decoder: the pipelined one where the kernels run
    # (a card, use_pallas not "off") and P <= 32768
    pipelined = stream.is_cuda and kernels_on(cfg) and cfg.n_chan * cfg.block_size <= 32768
    decode = decode_stream_pipelined if pipelined else decode_stream

    wav = WavWriter(argv[2], hdr.rate_hz, hdr.n_chan, bits, tag)
    n = hdr.block_size
    t0 = time.time()
    last_print = t0 - 0.5
    done = 0
    offset, carry = None, None
    failed = False
    with device_trace(profile_dir):
        while done < hdr.n_blocks and not failed:
            take = min(chunk, hdr.n_blocks - done)
            pcm, _, corrupt, (offset, carry) = decode(stream, take, window, cfg, offset=offset,
                                                      carry=carry, device=device)
            if bits in _INT_PCM:
                pcm = pcm_to_int(pcm, bits)
            corrupt_np = corrupt.cpu().numpy()
            if corrupt_np.any():
                print("ERROR: Corrupted stream.")
                failed = True
                take = int(np.argmax(corrupt_np))
            frames = pcm[:take].transpose(1, 2).reshape(-1).cpu().numpy()  # [take, C, N] -> frames
            if bits in _INT_PCM:
                wav.write_frames_int(frames)
            else:
                wav.write_frames(frames)
            done += take
            now = time.time()
            if now - last_print >= 0.5:
                rt = done * n / hdr.rate_hz / max(now - t0, 1e-9)
                print(
                    f"\rBlock {done}/{hdr.n_blocks} "
                    f"({done * 100.0 / hdr.n_blocks:.2f}% | {rt:.2f} X rt)",
                    end="",
                    flush=True,
                )
                last_print = now

    wav.close()
    if not failed:
        print("\nOk")
    return -1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
