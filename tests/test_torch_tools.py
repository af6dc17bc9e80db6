"""The port's CLI trio and its container and WAV I/O, on the CPU.

Modelled on tests/test_tools.py, test_miniriff.py and test_native_io.py,
with the port's modules and its tools at ``device="cpu"``:
- WAV I/O: the PCM converters round trip, the reader skips LIST and odd
  chunks and zero-pads, PCM8/PCM16 read as integers equal the float
  read, and the native library and the NumPy path give the same bytes;
- the decode tool's on-device PCM8/PCM16 conversion equals the host
  converter bit for bit, clamp edges and half-way ties included;
- round trips WAV -> .ulc -> WAV in CBR and VBR, to PCM8, PCM16 and
  FLOAT32; the batch tool writes the encode tool's files; the five error
  paths give ulcx's messages and exit codes;
- across packages: a ``.ulc`` from ulcx's encode tool decodes with the
  port's decode tool and one from the port's encode tool with ulcx's,
  the container headers and WAV headers byte-identical, the PCM within
  1e-5 RMS (FLOAT32) and one LSB (PCM16) of the other package's decode.
  ulcx's tools compile for tens of seconds on the CPU, so each runs once.
"""

import os
import struct

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ulcx.codec.decoder import decode_stream as j_decode_stream
from ulcx.tools.decode_tool import main as j_decode_main
from ulcx.tools.encode_tool import main as j_encode_main
from ulcx.utils.config import CodecConfig
from ulcx_torch.container import HEADER_SIZE, UlcHeader
from ulcx_torch.io import native
from ulcx_torch.io.miniriff import ChunkHandler, ListHandler, ck_read
from ulcx_torch.io.wavio import WavReader, WavWriter, float_to_raw, raw_to_float
from ulcx_torch.tools.batch_tool import main as batch_main
from ulcx_torch.tools.decode_tool import main as decode_main
from ulcx_torch.tools.decode_tool import pcm_to_int
from ulcx_torch.tools.encode_tool import main as encode_main
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N = 256
FORMATS = {"PCM8": (8, 1), "PCM16": (16, 1), "PCM24": (24, 1), "FLOAT32": (32, 3)}


def _read(path):
    r = WavReader(path)
    y = r.read_frames(r.info.n_samples).reshape(-1, r.info.n_chan)
    info = r.info
    r.close()
    return y, info


def _write(path, x, n_chan=2, bits=16, tag=1):
    w = WavWriter(path, 44100, n_chan, bits, tag)
    w.write_frames(x)
    w.close()


def _tone(n_blocks, freq=440.0, n_chan=2):
    """n_blocks blocks of a tone, interleaved; the second channel 0.8x."""
    t = np.arange(n_blocks * N) / 44100.0
    sig = 0.4 * np.sin(2 * np.pi * freq * t).astype(np.float32)
    return (np.stack([sig, 0.8 * sig], -1) if n_chan == 2 else sig[:, None]).reshape(-1)


def _snr(x, y, n_chan):
    """SNR in dB over blocks 1-3 of decoded y against input x one block
    earlier (the codec's delay)."""
    x, y = x.reshape(-1, n_chan), y.reshape(-1, n_chan)
    seg = slice(N, 4 * N)
    err = y[N: N + 5 * N][seg] - x[seg]
    return 10 * np.log10((x[seg] ** 2).mean() / max((err ** 2).mean(), 1e-12))


def test_pcm_conversions(rng):
    x = np.clip(rng.standard_normal(1000).astype(np.float32) * 0.3, -1, 1)
    for bits, tag in FORMATS.values():
        back = raw_to_float(float_to_raw(x, bits, tag).tobytes(), bits, tag)
        tol = {8: 2.0**-7, 16: 2.0**-15, 24: 2.0**-23, 32: 0.0}[bits]
        assert np.abs(back - x).max() <= tol, bits


def test_native_and_numpy_paths_agree(monkeypatch, rng):
    """The native library (when it loads) and the NumPy converters give
    the same bytes and floats; pack_blocks frames blocks back to back."""
    x = np.clip(rng.standard_normal(4096).astype(np.float32) * 0.7, -1.2, 1.2)
    got = {}
    for lib in (native._load(), False):
        monkeypatch.setattr(native, "_LIB", lib)
        raws = [float_to_raw(x, bits, tag) for bits, tag in FORMATS.values()]
        got[bool(lib)] = raws + [raw_to_float(r.tobytes(), bits, tag)
                                 for r, (bits, tag) in zip(raws, FORMATS.values())]
    for a, b in zip(*got.values()):
        assert a.tobytes() == b.tobytes()
    monkeypatch.setattr(native, "_LIB", None)
    data = rng.integers(0, 255, (5, 64), dtype=np.uint8)
    sizes = np.array([80, 24, 512, 8, 160], np.int32)
    packed = native.pack_blocks(data, sizes)
    if native.available():
        assert packed == b"".join(data[i, : sizes[i] // 8].tobytes() for i in range(5))


def test_wav_reader_skips_list_and_junk(tmp_path):
    """A LIST(INFO) sub-list and an odd-sized unknown chunk around
    fmt/data (MiniRIFF.c:14-16, 29-37); reads past the end zero-pad; the
    dispatcher's callbacks and a negative return stopping traversal."""
    pcm = (np.sin(np.arange(400) / 10) * 20000).astype("<i2")
    fmt = struct.pack("<HHIIHH", 1, 2, 44100, 44100 * 4, 4, 16)
    info = b"INFOIART" + struct.pack("<I", 5) + b"someo\x00"
    chunks = b"LIST" + struct.pack("<I", len(info)) + info
    chunks += b"fmt " + struct.pack("<I", len(fmt)) + fmt
    chunks += b"junk" + struct.pack("<I", 3) + b"abc\x00"
    data = np.repeat(pcm, 2).tobytes()
    chunks += b"data" + struct.pack("<I", len(data)) + data
    p = str(tmp_path / "x.wav")
    with open(p, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks)
    r = WavReader(p)
    assert (r.info.rate_hz, r.info.n_chan, r.info.n_samples) == (44100, 2, 400)
    y = r.read_frames(450).reshape(450, 2)
    r.close()
    np.testing.assert_array_equal(y[:400, 0], pcm.astype(np.float32) / 32768.0)
    assert (y[400:] == 0).all()

    seen = {"begin": 0, "end": 0, "fmt": 0, "data": 0}

    def count(key, ret):
        def fn(*args):
            seen[key] += 1
            return ret
        return fn

    wave = ListHandler(b"WAVE", [ChunkHandler(b"fmt ", count("fmt", 1)),
                                 ChunkHandler(b"data", count("data", -1))], [],
                       on_begin=count("begin", 0), on_end=count("end", 0))
    with open(p, "rb") as f:
        assert ck_read(f, None, None, [wave]) < 0
    assert seen == {"begin": 1, "end": 0, "fmt": 1, "data": 1}


def test_int_reads_equal_float_reads(tmp_path, rng):
    """read_frames_int * int_scale == read_frames for PCM8/PCM16 (the
    encode tool's integer upload); FLOAT32 has no integer form."""
    for bits in (8, 16):
        p = str(tmp_path / f"i{bits}.wav")
        _write(p, np.clip(rng.standard_normal(3000).astype(np.float32) * 0.5, -1, 1), bits=bits)
        r1, r2 = WavReader(p), WavReader(p)
        xi, xf = r1.read_frames_int(1600), r2.read_frames(1600)
        assert xi.dtype == (np.int8 if bits == 8 else np.int16)
        assert (xi.astype(np.float32) * np.float32(r1.int_scale()) == xf).all()
        r1.close(), r2.close()
    p = str(tmp_path / "f.wav")
    _write(p, np.zeros(64, np.float32), n_chan=1, bits=32, tag=3)
    r = WavReader(p)
    assert r.int_scale() is None
    r.close()


def test_device_pcm_conversion_bit_exact(rng):
    """pcm_to_int (the decode tool's conversion where the PCM lies) ==
    the host converter, clamp edges and round-half-even ties included."""
    edge = np.array([0.0, -0.0, 1.0, -1.0, 2.0, -2.0, 0.5, -0.5,
                     (0x7FFF + 0.5) * 2.0**-15, (0x7FFE + 0.5) * 2.0**-15,
                     -(0x8000 + 0.5) * 2.0**-15, 1.5 * 2.0**-15, 2.5 * 2.0**-15,
                     -1.5 * 2.0**-15, 1.5 * 2.0**-7, 2.5 * 2.0**-7, 3e-8, -3e-8], np.float32)
    x = np.concatenate([edge, np.clip(rng.standard_normal(4096).astype(np.float32) * 0.7,
                                      -1.2, 1.2)])
    got16 = pcm_to_int(torch.from_numpy(x), 16).numpy()
    assert got16.dtype == np.int16
    assert (got16.astype("<i2").view(np.uint8) == float_to_raw(x, 16, 1)).all()
    got8 = pcm_to_int(torch.from_numpy(x), 8).numpy()
    assert got8.dtype == np.int8
    assert ((got8.view(np.uint8) ^ np.uint8(0x80)) == float_to_raw(x, 8, 1)).all()


@pytest.mark.parametrize("rate_arg,bits,fmt", [("-90", 32, "FLOAT32"), ("400", 16, "PCM16"),
                                               ("200", 8, "PCM8")])
def test_tool_roundtrip(tmp_path, rate_arg, bits, fmt):
    """WAV -> .ulc -> WAV: header fields, length, SNR; PCM8 runs mono
    through the integer upload and the PCM8 store."""
    n_chan = 1 if bits == 8 else 2
    x = _tone(5, 500.0 if bits == 8 else 440.0, n_chan)
    wav_in, ulc, wav_out = (str(tmp_path / f) for f in ("in.wav", "a.ulc", "out.wav"))
    _write(wav_in, x, n_chan, 8 if bits == 8 else 16)
    assert encode_main(["enc", wav_in, ulc, rate_arg, f"-blocksize:{N}", "-chunk:4"],
                       device="cpu") == 0
    hdr = UlcHeader.unpack(open(ulc, "rb").read())
    assert (hdr.block_size, hdr.n_chan, hdr.n_blocks, hdr.rate_hz) == (N, n_chan, 7, 44100)
    assert hdr.max_block_size > 0 and hdr.rate_kbps > 0
    assert decode_main(["dec", ulc, wav_out, f"-format:{fmt}", "-chunk:3"], device="cpu") == 0
    y, info = _read(wav_out)
    assert (info.bits, info.n_samples) == (bits, hdr.n_blocks * N)
    assert _snr(x, y, n_chan) > (10.0 if bits == 8 else 12.0)


def test_cbr_budget_and_batch_tool(tmp_path):
    """CBR-128: no block over the budget (the header's largest block);
    the batch tool writes, for each of its files, the encode tool's
    bytes."""
    paths = []
    for k, freq in enumerate((440.0, 660.0, 880.0)):
        paths.append(str(tmp_path / f"in{k}.wav"))
        _write(paths[-1], _tone(5 + k, freq))
    outs = []
    for p in paths:
        outs.append(p[:-4] + ".ulc")
        # eight blocks a call: the tool pads the last chunk to it, as ulcx's does
        assert encode_main(["e", p, outs[-1], "128", f"-blocksize:{N}", "-chunk:8"],
                           device="cpu") == 0
        hdr = UlcHeader.unpack(open(outs[-1], "rb").read())
        assert hdr.max_block_size * 8 <= int(N * 128.0 * 1000.0 / 44100.0)
    out_dir = str(tmp_path / "batch")
    assert batch_main(["b", out_dir, "128", *paths, f"-blocksize:{N}", "-chunk:2"],
                      device="cpu") == 0
    for p, want in zip(paths, outs):
        got = os.path.join(out_dir, os.path.basename(want))
        assert open(got, "rb").read() == open(want, "rb").read()


def test_batch_tool_pads_to_eight(tmp_path, monkeypatch, capsys):
    """Three files: the tool pads the batch with zero streams to eight, as
    ulcx's does, so each block step takes the kernel path's plan, the
    walks launched (3, 3, 2, 1) times (not the scan path's (7, 7, 6, 1));
    its files are the first three rows of encode_stream_batched over the
    zero-padded eight-row batch, framed as the tool frames them; its
    messages count the three real files."""
    from test_torch_rate_paths import _counting
    from ulcx_torch.codec.encoder import encode_stream_batched
    from ulcx_torch.utils.config import CodecConfig as TCodecConfig

    paths = []
    for k, freq in enumerate((440.0, 660.0, 880.0)):
        paths.append(str(tmp_path / f"in{k}.wav"))
        _write(paths[-1], _tone(5 + k, freq))
    counts = _counting(monkeypatch)
    out_dir = str(tmp_path / "batch")
    assert batch_main(["b", out_dir, "128", *paths, f"-blocksize:{N}", "-chunk:4"],
                      device="cpu") == 0
    out = capsys.readouterr().out
    assert "Encoded 3 files." in out
    n_blocks = [5 + k + 2 for k in range(3)]
    t_total = max(n_blocks)
    assert tuple(counts.values()) == tuple(t_total * w for w in (3, 3, 2, 1))

    x = np.zeros((8, t_total, 2, N), np.float32)
    for i, p in enumerate(paths):
        r = WavReader(p)
        x[i] = r.read_frames(t_total * N).reshape(t_total, N, 2).transpose(0, 2, 1)
        r.close()
    cfg = TCodecConfig(rate_hz=44100, n_chan=2, block_size=N)
    enc, _ = encode_stream_batched(torch.from_numpy(x), cfg, "cbr", rate_kbps=128.0)
    sizes, data = enc.size_bits.numpy(), enc.data.numpy()
    for i, (p, nb) in enumerate(zip(paths, n_blocks)):
        body = b"".join(data[i, j, : sizes[i, j] // 8].tobytes() for j in range(nb))
        hdr = UlcHeader(block_size=N, max_block_size=int(sizes[i, :nb].max()) // 8, n_blocks=nb,
                        rate_hz=44100, n_chan=2,
                        rate_kbps=int(round(len(body) * 8.0 * 44100 / 1000.0 / (nb * N))) & 0xFFFF)
        got = open(os.path.join(out_dir, f"in{i}.ulc"), "rb").read()
        assert got == hdr.pack() + body, i


def test_error_paths(tmp_path, capsys):
    """The verify SKILL's five: rate 0, a block size not a power of two,
    an unknown output format, a file that is no container, a truncated
    stream (-1: exit 255 from the command line, chip_smoke.py phase 16)."""
    wav, ulc = str(tmp_path / "in.wav"), str(tmp_path / "a.ulc")
    _write(wav, _tone(5))
    assert encode_main(["e", wav, ulc, "128", f"-blocksize:{N}", "-chunk:8"], device="cpu") == 0
    capsys.readouterr()
    cases = [
        (encode_main, ["e", wav, str(tmp_path / "z.ulc"), "0"], 1, "ERROR: Invalid coding rate"),
        (encode_main, ["e", wav, str(tmp_path / "z.ulc"), "128", "-blocksize:1000"], 1,
         "ERROR: Unsupported block size"),
        (decode_main, ["d", ulc, str(tmp_path / "z.wav"), "-format:MP3"], -1,
         "ERROR: Ignoring invalid output format"),
    ]
    garbage = str(tmp_path / "g.ulc")
    with open(garbage, "wb") as f:
        f.write(b"garbage" * 10)
    cases.append((decode_main, ["d", garbage, str(tmp_path / "z.wav")], -1,
                  "ERROR: Input file is not a valid ULC container"))
    truncated = str(tmp_path / "t.ulc")
    data = open(ulc, "rb").read()
    with open(truncated, "wb") as f:
        f.write(data[: HEADER_SIZE + (len(data) - HEADER_SIZE) // 2])
    cases.append((decode_main, ["d", truncated, str(tmp_path / "z.wav")], -1,
                  "ERROR: Corrupted stream."))
    for fn, argv, rc, msg in cases:
        assert fn(argv, device="cpu") == rc, argv
        assert msg in capsys.readouterr().out, argv


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """The 7-block bs256 WAV of tests/test_tools.py, encoded CBR-128 by
    both packages' encode tools; ulcx's decode tool decodes the port's
    file to FLOAT32 (each ulcx tool runs once)."""
    d = tmp_path_factory.mktemp("cross")
    wav = str(d / "in.wav")
    _write(wav, _tone(5))
    args = ["128", f"-blocksize:{N}", "-chunk:4"]
    paths = {k: str(d / f"{k}.ulc") for k in ("ulcx", "port")}
    assert j_encode_main(["e", wav, paths["ulcx"], *args]) == 0
    assert encode_main(["e", wav, paths["port"], *args], device="cpu") == 0
    ulcx_wav = str(d / "ulcx_of_port.wav")
    assert j_decode_main(["d", paths["port"], ulcx_wav, "-format:FLOAT32", "-chunk:4"]) == 0
    return d, paths, ulcx_wav


def _port_decode(d, ulc, fmt):
    out = str(d / f"{os.path.basename(ulc)}.{fmt}.wav")
    assert decode_main(["d", ulc, out, f"-format:{fmt}", "-chunk:4"], device="cpu") == 0
    return out


def _ulcx_decode(ulc):
    """ulcx's decode_stream of a .ulc (the decode tool's path on the
    CPU), as interleaved float frames."""
    raw = open(ulc, "rb").read()
    hdr = UlcHeader.unpack(raw)
    cfg = CodecConfig(rate_hz=hdr.rate_hz, n_chan=hdr.n_chan, block_size=hdr.block_size)
    win = -(-max(hdr.max_block_size, 16) // 64) * 64
    s = np.concatenate([np.frombuffer(raw[hdr.stream_offs:], np.uint8), np.zeros(win + 64, np.uint8)])
    pcm, _, corrupt, _ = jax.jit(lambda s: j_decode_stream(s, hdr.n_blocks, win, cfg))(jnp.asarray(s))
    assert not np.asarray(corrupt).any()
    return np.asarray(pcm).transpose(0, 2, 1).reshape(-1)


def _close(got16, got32, want):
    """PCM16 within one LSB and FLOAT32 within 1e-5 RMS of ``want``."""
    want16 = float_to_raw(want, 16, 1).view("<i2").astype(np.int32)
    assert np.abs(got16.reshape(-1) * 32768.0 - want16).max() <= 1
    assert np.sqrt(np.mean((got32.reshape(-1) - want) ** 2)) <= 1e-5


def test_cross_container_headers(cross):
    """Both encode tools write the same ULC2 header for the same input."""
    _, paths, _ = cross
    heads = [open(p, "rb").read()[:HEADER_SIZE] for p in paths.values()]
    assert heads[0] == heads[1]
    hdr = UlcHeader.unpack(heads[0])
    assert (hdr.block_size, hdr.n_chan, hdr.n_blocks) == (N, 2, 7)


def test_port_decodes_ulcx_file(cross):
    """ulcx's .ulc through the port's decode tool against ulcx's decoder."""
    d, paths, _ = cross
    got16, _ = _read(_port_decode(d, paths["ulcx"], "PCM16"))
    got32, _ = _read(_port_decode(d, paths["ulcx"], "FLOAT32"))
    _close(got16, got32, _ulcx_decode(paths["ulcx"]))


def test_ulcx_decodes_port_file(cross):
    """The port's .ulc through ulcx's decode tool against the port's;
    the two tools' WAV headers byte-identical."""
    d, paths, ulcx_wav = cross
    port32 = _port_decode(d, paths["port"], "FLOAT32")
    got16, _ = _read(_port_decode(d, paths["port"], "PCM16"))
    got32, _ = _read(port32)
    want, info = _read(ulcx_wav)
    assert info.n_samples == 7 * N
    _close(got16, got32, want.reshape(-1))
    assert open(port32, "rb").read()[:44] == open(ulcx_wav, "rb").read()[:44]
