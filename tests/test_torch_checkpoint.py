"""Checkpoints of the port's carries, across packages, and its profiler hook.

- The port's ``.npz`` loads with ``ulcx.utils.checkpoint.load_carry`` and
  ulcx's with the port's, every leaf bit-equal, for the encoder's and the
  decoder's carry, single and batched; the decoder's RNG state keeps its
  bits (a state past 2^31 among them).
- Stopping mid-stream, saving, loading and resuming gives one call's
  bytes (encode) and PCM (decode).
- A structure, leaf-count or shape mismatch raises ulcx's messages.
- ``utils.profiling.device_trace`` writes a trace on the CPU, and writes
  nothing when given no directory.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ulcx.analysis.block import EncoderCarry as JEncoderCarry
from ulcx.analysis.window_control import TransientState as JTransientState
from ulcx.codec.decoder import DecoderCarry as JDecoderCarry
from ulcx.codec.encoder import init_carry_batched as j_init_batched
from ulcx.utils import checkpoint as jck
from ulcx.utils.config import CodecConfig
from ulcx_torch.analysis.block import EncoderCarry, carry_to_numpy
from ulcx_torch.codec.decoder import DecoderCarry, decode_stream, decoder_carry_to_numpy
from ulcx_torch.codec.encoder import encode_stream, encode_stream_batched, max_block_bytes
from ulcx_torch.utils import checkpoint as tck
from ulcx_torch.utils.config import CodecConfig as TCodecConfig
from ulcx_torch.utils.profiling import annotate, device_trace

N = 256
KW = dict(rate_hz=44100, n_chan=2, block_size=N)
CFG, TCFG = CodecConfig(**KW), TCodecConfig(**KW)
VBR = {"quality": 70.0}


def _one(carry):
    """A batch-of-one carry without its batch axis."""
    return type(carry)(*(_one(x) if isinstance(x, tuple) else x[0] for x in carry))


@pytest.fixture(scope="module")
def streams():
    """Six bs256 blocks of one stream, the port's encode of them (VBR),
    the packed bytes and the decoder's window."""
    x = np.random.default_rng(7).standard_normal((6, 2, N)).astype(np.float32) * 0.3
    out, _ = encode_stream(x, TCFG, "vbr", device="cpu", **VBR)
    sizes, data = out.size_bits.numpy(), out.data.numpy()
    s = b"".join(data[i, : sizes[i] // 8].tobytes() for i in range(6))
    win = max_block_bytes(TCFG)
    stream = np.concatenate([np.frombuffer(s, np.uint8), np.zeros(win + 8, np.uint8)])
    return x, out, torch.from_numpy(stream), win


def _carries(streams):
    """The port's carries after three blocks: encoder and decoder, single
    and (the encoder) batched, and the decoder's with a state >= 2^31."""
    x, _, stream, win = streams
    _, enc = encode_stream(x[:3], TCFG, "vbr", device="cpu", **VBR)
    _, enc_b = encode_stream_batched(torch.from_numpy(np.stack([x[:3], -x[:3]])), TCFG, "vbr",
                                     **VBR)
    *_, (_, dec) = decode_stream(stream, 3, win, TCFG, device="cpu")
    high = dec._replace(rng=torch.tensor(np.uint32(0xDEADBEEF).view(np.int32)))
    return {"encoder": enc, "encoder batched": enc_b, "decoder": dec, "decoder high rng": high}


def _ulcx_like(name):
    return {"encoder": JEncoderCarry.init(CFG), "encoder batched": j_init_batched(CFG, 2),
            "decoder": JDecoderCarry.init(CFG), "decoder high rng": JDecoderCarry.init(CFG)}[name]


def _as_ulcx(name, carry):
    """The port's carry as ulcx's (numpy leaves into ulcx's types)."""
    if name.startswith("decoder"):
        c = decoder_carry_to_numpy(carry)
        return JDecoderCarry(jnp.asarray(c.lap), jnp.asarray(c.prev_last_ss), jnp.asarray(c.rng))
    c = carry_to_numpy(carry)
    return JEncoderCarry(jnp.asarray(c.sample_prev), JTransientState(*map(jnp.asarray, c.transient)),
                         jnp.asarray(c.next_window_ctrl), jnp.asarray(c.prev_last_ss))


def _leaf_bits(carry):
    """Every leaf's bits (all leaves are 4-byte words)."""
    return [np.asarray(x).view(np.uint32) for x in jax.tree_util.tree_leaves(carry)]


@pytest.mark.parametrize("name", ["encoder", "encoder batched", "decoder", "decoder high rng"])
def test_files_load_across_packages(tmp_path, streams, name):
    carry = _carries(streams)[name]
    want = _as_ulcx(name, carry)
    assert tck.treedef(carry) == str(jax.tree_util.tree_structure(want))
    port_file, ulcx_file = str(tmp_path / "port.npz"), str(tmp_path / "ulcx.npz")
    tck.save_carry(port_file, carry)
    got = jck.load_carry(port_file, _ulcx_like(name))
    for a, b in zip(_leaf_bits(got), _leaf_bits(want)):
        np.testing.assert_array_equal(a, b)
    jck.save_carry(ulcx_file, want)
    back = tck.load_carry(ulcx_file, carry)
    for a, b in zip(tck._leaves(back), tck._leaves(carry)):
        assert a[0] == b[0] and a[1].dtype == b[1].dtype
        assert torch.equal(a[1], b[1]), a[0]


def test_encoder_resume(tmp_path, streams):
    """Three blocks, a checkpoint on disk, three more: one call's bytes."""
    x, full, _, _ = streams
    head, carry = encode_stream(x[:3], TCFG, "vbr", device="cpu", **VBR)
    path = str(tmp_path / "enc.npz")
    tck.save_carry(path, carry)
    like = _one(EncoderCarry.init(TCFG, 1, "cpu"))
    tail, _ = encode_stream(x[3:], TCFG, "vbr", carry=tck.load_carry(path, like), device="cpu",
                            **VBR)
    for name in ("size_bits", "data", "window_ctrl"):
        assert torch.equal(torch.cat([getattr(head, name), getattr(tail, name)]),
                           getattr(full, name)), name


def test_decoder_resume(tmp_path, streams):
    _, _, stream, win = streams
    pcm, bits, corrupt, _ = decode_stream(stream, 6, win, TCFG, device="cpu")
    assert not corrupt.any()
    pcm_a, _, _, (off, carry) = decode_stream(stream, 3, win, TCFG, device="cpu")
    path = str(tmp_path / "dec.npz")
    tck.save_carry(path, carry)
    loaded = tck.load_carry(path, _one(DecoderCarry.init(TCFG, 1, "cpu")))
    pcm_b, bits_b, _, _ = decode_stream(stream, 3, win, TCFG, offset=off, carry=loaded,
                                        device="cpu")
    assert torch.equal(torch.cat([pcm_a, pcm_b]), pcm)
    assert torch.equal(bits_b, bits[3:])


def test_mismatches_raise(tmp_path, streams):
    enc = _carries(streams)["encoder"]
    path = str(tmp_path / "c.npz")
    tck.save_carry(path, enc)
    with pytest.raises(ValueError, match="structure mismatch"):
        tck.load_carry(path, _one(DecoderCarry.init(TCFG, 1, "cpu")))
    with pytest.raises(ValueError, match="leaf 0 shape"):
        tck.load_carry(path, EncoderCarry.init(TCFG, 2, "cpu"))
    with np.load(path) as data:
        files = {k: data[k] for k in data.files}
    np.savez(path, **files, leaf_8=np.zeros(1, np.float32))
    with pytest.raises(ValueError, match="has 9 leaves, expected 8"):
        tck.load_carry(path, enc)


def test_device_trace(tmp_path):
    trace_dir = str(tmp_path / "trace")
    with device_trace(trace_dir), annotate("step"):
        torch.ones(64).cumsum(0)
    files = os.listdir(trace_dir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert b"step" in open(os.path.join(trace_dir, files[0]), "rb").read()
    with device_trace(None):
        torch.ones(1)
