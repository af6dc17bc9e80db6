"""ulcbatchtool — batched corpus encoder (the port of ``ulcx.tools.batch_tool``).

Encodes many WAV files at once on the card: all files become one
[streams, blocks, channels, block_size] batch, encoded chunk by chunk
through ``encode_stream_batched`` with the carry passed on; every input
gets its own `.ulc`.

Usage:
    python -m ulcx_torch.tools.batch_tool out_dir rate_spec in1.wav in2.wav ...
        [-blocksize:2048] [-chunk:16]

rate_spec follows ulcencodetool (RateKbps[,AvgComplexity] | -Quality).
All inputs must share sample rate and channel count; streams of fewer
blocks are zero-padded to the longest, and the batch is padded with zero
streams to a multiple of 8, as ulcx's tool pads it, so that it takes the
kernel path's plan (``codec.encoder._use_kernel``). ``main(argv,
device="cpu")`` encodes on the CPU (the tests).
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time

import numpy as np

from ulcx_torch.container import UlcHeader
from ulcx_torch.io import native
from ulcx_torch.io.wavio import WavReader
from ulcx_torch.tools.encode_tool import rate_mode
from ulcx_torch.utils.config import CodecConfig
from ulcx_torch.utils.device import on_device


def main(argv=None, device="cuda") -> int:
    argv = sys.argv if argv is None else argv
    if len(argv) < 4:
        print(__doc__)
        return 1
    out_dir = argv[1]
    rate_spec = argv[2].split(",")
    rate_kbps = float(rate_spec[0])
    avg_cx = float(rate_spec[1]) if len(rate_spec) > 1 else 0.0
    block_size = 2048
    chunk = 16
    paths = []
    for a in argv[3:]:
        if a.startswith("-blocksize:"):
            block_size = int(a[len("-blocksize:") :])
        elif a.startswith("-chunk:"):
            chunk = max(1, int(a[len("-chunk:") :]))
        else:
            paths.append(a)
    if not paths:
        print("ERROR: no input files.")
        return 1

    from ulcx_torch.codec.encoder import encode_stream_batched, init_carry_batched

    readers = [WavReader(p) for p in paths]
    rate_hz = readers[0].info.rate_hz
    n_chan = readers[0].info.n_chan
    for r, p in zip(readers, paths):
        if r.info.rate_hz != rate_hz or r.info.n_chan != n_chan:
            print(f"ERROR: {p} format differs (batch must be homogeneous).")
            return 1

    cfg = CodecConfig(rate_hz=rate_hz, n_chan=n_chan, block_size=block_size)
    n_blocks = [(r.info.n_samples + block_size - 1) // block_size + 2 for r in readers]
    t_total = max(n_blocks)
    b_real = len(paths)
    b = ((b_real + 7) // 8) * 8  # kernel path wants a multiple of 8
    mode, kw = rate_mode(rate_kbps, avg_cx)

    os.makedirs(out_dir, exist_ok=True)
    outs = []
    for p, nb in zip(paths, n_blocks):
        f = open(os.path.join(out_dir, os.path.splitext(os.path.basename(p))[0] + ".ulc"), "wb")
        hdr = UlcHeader(
            block_size=block_size,
            max_block_size=0,
            n_blocks=nb,
            rate_hz=rate_hz,
            n_chan=n_chan,
            rate_kbps=0,
        )
        f.write(hdr.pack())
        outs.append([f, hdr, 0, 0])  # file, header, total_bytes, max_bytes

    # as in encode_tool: a reader thread prepares the next chunk while the
    # device encodes this one, whose outputs are fetched after the next
    # chunk is queued
    q: queue.Queue = queue.Queue(maxsize=2)

    def _reader():
        # exceptions go through the queue: a reader that died silently
        # would leave the main loop waiting on q.get() forever
        try:
            done_r = 0
            while done_r < t_total:
                # the last chunk keeps its ``take`` blocks: the plan is
                # routed by the batch, not by the blocks of a call (the
                # bitstream stages run block by block)
                take = min(chunk, t_total - done_r)
                batch = np.zeros((b, take, n_chan, block_size), np.float32)
                for i, r in enumerate(readers):
                    frames = r.read_frames(take * block_size)
                    batch[i] = frames.reshape(take, block_size, n_chan).transpose(0, 2, 1)
                q.put((batch, take, done_r))
                done_r += take
            q.put(None)
        except BaseException as e:  # noqa: BLE001
            q.put(e)

    rd = threading.Thread(target=_reader, daemon=True)
    rd.start()

    carry = init_carry_batched(cfg, b, device)
    t0 = time.time()
    done = 0

    def _flush(enc, take, base):
        nonlocal done
        sizes = enc.size_bits[:b_real].cpu().numpy()
        datas = enc.data[:b_real, :, : int(sizes.max()) // 8].cpu().numpy()
        for i, (f, hdr, _, _) in enumerate(outs):
            vc = max(0, min(take, n_blocks[i] - base))
            if vc == 0:
                continue
            packed = native.pack_blocks(datas[i, :vc], sizes[i, :vc])
            if packed is not None:  # C++ fast path: one write per file
                f.write(packed)
                outs[i][2] += len(packed)
            else:
                for j in range(vc):
                    nb_ = int(sizes[i, j]) // 8
                    f.write(datas[i, j, :nb_].tobytes())
                    outs[i][2] += nb_
            outs[i][3] = max(outs[i][3], int(sizes[i, :vc].max()) // 8)
        done = base + take
        rt = done * block_size * b_real / rate_hz / max(time.time() - t0, 1e-9)
        print(
            f"\r{done}/{t_total} block rows ({rt:.0f}x realtime aggregate)",
            end="",
            flush=True,
        )

    pending = None
    while True:
        item = q.get()
        if item is None:
            break
        if isinstance(item, BaseException):
            raise item
        batch, take, base = item
        enc, carry = encode_stream_batched(on_device(batch, device), cfg, mode, carry=carry, **kw)
        if pending is not None:
            _flush(*pending)
        pending = (enc, take, base)
    if pending is not None:
        _flush(*pending)
    rd.join()

    for i, (f, hdr, total, mx) in enumerate(outs):
        hdr.max_block_size = mx
        hdr.rate_kbps = (
            int(round(total * 8.0 * rate_hz / 1000.0 / (n_blocks[i] * block_size)))
            & 0xFFFF
        )
        f.seek(0)
        f.write(hdr.pack())
        f.close()
    for r in readers:
        r.close()
    print(f"\nEncoded {b_real} files.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
