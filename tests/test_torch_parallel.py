"""The data-parallel slice: the port's mesh against its own no-mesh path
and against ulcx's mesh.

One ``torchrun`` of two CPU ranks over gloo (``python -m
ulcx_torch.graft_entry mesh``) encodes B=4 stereo bs256 streams of
``bench.make_corpus``, T=2 blocks, at CBR-128 through
``batch_encode(mesh=)``, decodes them and ulcx's bytes through
``batch_decode(mesh=)``, probes the refusals, and writes each rank's
shard to a file; the tests read the files, so the file pays for one
launch. ulcx's side is its ``batch_encode`` over a mesh of two of its
CPU devices (its scan path: ulcx's kernels need 8 streams a shard) and
its kernel decoder (``use_pallas="on"``, interpret mode) over the same
mesh. On the CPU the shards are the whole batch's bytes exactly; against
ulcx the slice's bounds hold (window control and coded counts exact,
total within 1 %, round-trip SNR within 0.3 dB; decode: bits and corrupt
flags exact, PCM within 1e-5 RMS).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import entry as j_entry
from bench import make_corpus
from test_torch_encode import _n_nz_port, _n_nz_ulcx
from ulcx.parallel.mesh import batch_decode as j_batch_decode
from ulcx.parallel.mesh import batch_encode as j_batch_encode
from ulcx.parallel.mesh import data_mesh as j_data_mesh
from ulcx.utils.config import CodecConfig
from ulcx_torch import graft_entry
from ulcx_torch.parallel.mesh import batch_decode, batch_encode, data_mesh
from ulcx_torch.utils.config import CodecConfig as TCodecConfig

N, C, B, T, RANKS = 256, 2, 4, 2, 2
KW = dict(rate_hz=44100, n_chan=C, block_size=N)
CFG, TCFG = CodecConfig(**KW), TCodecConfig(**KW)  # ulcx's, the port's
J_DEC_CFG = CodecConfig(**KW, use_pallas="on")  # ulcx's kernel decoder
RATE = {"rate_kbps": 128.0}
BUDGET = int(N * 128.0 * 1000.0 / 44100.0)
PCM_RMS = 1e-5
LAUNCH_S = 300  # the torchrun's limit; it takes ~10 s


def _snr(x, pcm):
    """Round-trip SNR in dB of decoded block t against input block t-1."""
    want = x[:, : pcm.shape[1] - 1]
    err = pcm[:, 1:] - want
    return 10 * np.log10((want ** 2).sum() / (err ** 2).sum())


@pytest.fixture(scope="module")
def x():
    return make_corpus(B, T, N).astype(np.float32)


@pytest.fixture(scope="module")
def ulcx_mesh(x):
    """ulcx's mesh encode of x, its bytes packed into streams, and its
    mesh decode of them."""
    mesh = j_data_mesh(jax.devices()[:RANKS])
    out, stats = jax.jit(lambda b: j_batch_encode(b, CFG, "cbr", mesh=mesh, **RATE))(
        jnp.asarray(x))
    sizes, data = np.asarray(out.size_bits), np.asarray(out.data)
    win = graft_entry.bench_window(sizes)
    streams = graft_entry.pack_streams(sizes, data, win)
    dec = jax.jit(lambda s: j_batch_decode(s, T, win, J_DEC_CFG, mesh=mesh))(jnp.asarray(streams))
    return {"sizes": sizes, "window_ctrl": np.asarray(out.window_ctrl),
            "total_bits": np.asarray(stats["total_bits"]), "streams": streams, "win": win,
            "pcm": np.asarray(dec[0]), "bits": np.asarray(dec[1]), "corrupt": np.asarray(dec[2])}


@pytest.fixture(scope="module")
def ranks(x, ulcx_mesh, tmp_path_factory):
    """Each rank's file of the one two-rank launch."""
    d = tmp_path_factory.mktemp("mesh")
    np.savez(d / "in.npz", x=x, streams=ulcx_mesh["streams"], n_blocks=T,
             window=ulcx_mesh["win"])
    graft_entry.launch(RANKS, ["mesh", d / "in.npz", d, "cpu", 1], timeout=LAUNCH_S)
    files = [dict(np.load(d / f"rank{r}.npz")) for r in range(RANKS)]
    assert [f["rows"].tolist() for f in files] == [[0, 2], [2, 4]]
    assert all(f["backend"] == "gloo" and f["device"] == "cpu" for f in files)
    return files


def _whole(ranks, key):
    return np.concatenate([f[key] for f in ranks])


def test_mesh_matches_no_mesh(x, ranks):
    """The shards, concatenated, are the no-mesh call's blocks; each is
    the no-mesh call on its own rows; the stats are ulcx's mesh form."""
    want, _ = batch_encode(x, TCFG, "cbr", device="cpu", **RATE)
    for key in ("data", "size_bits", "window_ctrl"):
        np.testing.assert_array_equal(_whole(ranks, key), getattr(want, key).numpy(), err_msg=key)
        for f in ranks:
            np.testing.assert_array_equal(f[key], f[f"alone_{key}"], err_msg=key)
    s0, s1 = (int(f["size_bits"].sum()) for f in ranks)
    for f in ranks:  # replicated, float32, summed as ulcx's psum sums
        assert f["total_bits"].dtype == np.float32
        assert f["total_bits"] == np.float32(np.float32(s0) + np.float32(s1))
        avg = want.complexity.double().mean().item()
        assert abs(float(f["avg_complexity"]) - avg) <= 1e-6 * abs(avg)
        assert f["major_shape"].tolist() == [T, B // RANKS] and f["major_same"]


def test_mesh_matches_ulcx_mesh(x, ranks, ulcx_mesh):
    sizes = _whole(ranks, "size_bits")
    np.testing.assert_array_equal(_whole(ranks, "window_ctrl"), ulcx_mesh["window_ctrl"])
    np.testing.assert_array_equal(_n_nz_port(x), _n_nz_ulcx(x))
    assert (sizes <= BUDGET).all()
    w_total = int(ulcx_mesh["sizes"].sum())
    assert abs(int(sizes.sum()) - w_total) <= 0.01 * w_total
    assert ulcx_mesh["total_bits"].dtype == np.float32
    assert abs(float(ranks[0]["total_bits"]) - float(ulcx_mesh["total_bits"])) <= 0.01 * w_total

    assert not _whole(ranks, "corrupt").any()
    np.testing.assert_array_equal((_whole(ranks, "bits") + 7) // 8 * 8, sizes)
    snr, snr_ulcx = _snr(x, _whole(ranks, "pcm")), _snr(x, ulcx_mesh["pcm"])
    assert abs(snr - snr_ulcx) <= 0.3, (snr, snr_ulcx)


def test_mesh_decode_matches_ulcx(ranks, ulcx_mesh):
    """ulcx's bytes through both meshes' decoders."""
    np.testing.assert_array_equal(_whole(ranks, "given_bits"), ulcx_mesh["bits"])
    np.testing.assert_array_equal(_whole(ranks, "given_corrupt"), ulcx_mesh["corrupt"])
    assert not ulcx_mesh["corrupt"].any()
    pcm = _whole(ranks, "given_pcm")
    assert pcm.shape == (B, T, C, N)
    rms = np.sqrt(np.mean((pcm - ulcx_mesh["pcm"]) ** 2))
    assert rms <= PCM_RMS, rms


def test_mesh_refusals(ranks):
    """Inside the ranks: a batch that does not split, and a device off
    the mesh, raise ValueError."""
    for f in ranks:
        assert "B=3" in str(f["refuse_split"]) and "n=2" in str(f["refuse_split"])
        assert "not this rank's mesh device" in str(f["refuse_device"])


def test_world_of_one(x):
    """Outside torchrun the mesh is this process on one device: the
    whole batch, its no-mesh bytes, the stats in float32."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data_mesh()  # the default puts the rank on a card
    mesh = data_mesh(["cpu"])
    try:
        assert (mesh.rank, mesh.world_size, mesh.device.type) == (0, 1, "cpu")
        assert mesh.device_mesh.mesh_dim_names == ("data",)
        got, stats = batch_encode(x, TCFG, "cbr", mesh=mesh, device="cpu", **RATE)
        want, _ = batch_encode(x, TCFG, "cbr", device="cpu", **RATE)
        assert torch.equal(got.data, want.data) and torch.equal(got.size_bits, want.size_bits)
        assert stats["total_bits"].dtype == torch.float32
        assert float(stats["total_bits"]) == float(want.size_bits.sum())
        with pytest.raises(ValueError, match="mesh device"):
            batch_decode(np.zeros((B, 64), np.uint8), 1, 32, TCFG, mesh=mesh)  # "cuda"
    finally:
        mesh.close()


def test_entry_matches_ulcx_entry():
    """The port's entry step on the CPU against ulcx's: sizes within the
    slice's 1 % total bound."""
    fn, args = graft_entry.entry(device="cpu")
    data, size, carry = fn(*args)
    assert data.shape == (8, 4096) and (size > 0).all()
    j_fn, j_args = j_entry()
    _, j_size, _ = jax.jit(j_fn)(*j_args)
    w_total = int(np.asarray(j_size).sum())
    assert abs(int(size.sum()) - w_total) <= 0.01 * w_total


def test_dryrun_multichip_2(capsys):
    graft_entry.dryrun_multichip(RANKS, device_type="cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("dryrun_")]
    assert len(lines) == 2 and all(": ok" in ln for ln in lines), lines
