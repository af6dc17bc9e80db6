"""The port's own CodecConfig against ulcx's, and the entry points'
device default.

The port keeps a copy of ``ulcx.utils.config`` (it imports nothing of
``ulcx``), so one set of keyword arguments must configure both alike:
every field's default and value, and every derived property the port
reads. And ``batch_encode``/``batch_decode`` run on the card unless
asked for the CPU: with no card they raise instead of running on the
CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ulcx.utils import config as jconfig
from ulcx_torch.parallel.mesh import batch_decode, batch_encode
from ulcx_torch.utils import config as tconfig

CASES = {
    "stereo bs2048": dict(rate_hz=44100, n_chan=2, block_size=2048),
    "mono bs256": dict(rate_hz=48000, n_chan=1, block_size=256),
    "8 ch bs4096": dict(rate_hz=44100, n_chan=8, block_size=4096, transform_backend="matmul",
                        matmul_max_n=4096),
    "vbr, no window switching": dict(n_chan=2, block_size=1024, use_window_switching=False,
                                     use_pallas="on"),
    "no noise coding": dict(n_chan=2, block_size=512, use_noise_coding=False,
                            use_psychoacoustics=False, rate_search="bisect"),
    "gap window, folded": dict(noise_run_window="gap", use_pallas="off", fold_bitstream=4,
                               flat_stream=True, transform_backend="fact"),
}
CONSTANTS = ("MIN_CHANS", "MAX_CHANS", "MIN_BANDS", "MAX_BANDS", "MAX_BLOCK_DECIMATION_FACTOR",
             "MAX_SUBBLOCKS", "COEF_EPS", "N_BARK_BANDS")


def test_fields_and_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.CodecConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.CodecConfig)}
    assert tf == jf
    for name in CONSTANTS:
        assert getattr(tconfig, name) == getattr(jconfig, name), name


@pytest.mark.parametrize("case", list(CASES))
def test_config_matches_ulcx(case):
    kw = CASES[case]
    j, t = jconfig.CodecConfig(**kw), tconfig.CodecConfig(**kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.max_decimation == j.max_decimation
    assert t.subblock_sizes == j.subblock_sizes
    for n in (64, 128, 256, 512, 1024, 2048, 4096, 8192, 32768):
        assert t.transform_for(n) == j.transform_for(n), n


@pytest.mark.parametrize("kw", [
    dict(n_chan=0), dict(n_chan=256), dict(block_size=1000), dict(block_size=128),
    dict(rate_hz=0), dict(transform_backend="dft"), dict(rate_search="exhaustive"),
    dict(noise_run_window="x"), dict(use_pallas="yes"), dict(fold_bitstream=0),
    dict(noise_run_window="gap", use_pallas="on"),
])
def test_config_refuses_what_ulcx_refuses(kw):
    with pytest.raises(ValueError):
        jconfig.CodecConfig(**kw)
    with pytest.raises(ValueError):
        tconfig.CodecConfig(**kw)


def test_entry_points_default_to_the_card():
    """No ``device`` means the card: without one, both entry points raise
    rather than quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    cfg = tconfig.CodecConfig(rate_hz=44100, n_chan=2, block_size=256)
    x = np.zeros((2, 1, 2, 256), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_encode(x, cfg, "cbr", rate_kbps=128.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_decode(np.zeros((2, 4096), np.uint8), 1, 64, cfg)
