"""Codec configuration: the reference's own, re-exported.

``ulcx.utils.config`` imports nothing of jax, so the port shares it
rather than copying it. The port serves only part of it; see
``check_supported``.
"""

from __future__ import annotations

from ulcx.utils.config import (  # noqa: F401
    COEF_EPS,
    MAX_BANDS,
    MAX_BLOCK_DECIMATION_FACTOR,
    MAX_CHANS,
    MAX_SUBBLOCKS,
    MIN_BANDS,
    MIN_CHANS,
    N_BARK_BANDS,
    CodecConfig,
)


def _check_transforms(cfg: CodecConfig) -> None:
    for ss in cfg.subblock_sizes:
        backend = cfg.transform_for(ss)
        if backend != "matmul" or ss > cfg.matmul_max_n:
            raise NotImplementedError(
                f"transform backend {backend!r} (subblock {ss} with "
                f"matmul_max_n={cfg.matmul_max_n}) is not ported: ROADMAP A.7"
            )


def check_supported(cfg: CodecConfig) -> None:
    """Raise NotImplementedError for encoder settings this port does not
    serve yet, naming the ROADMAP item that will. ``fold_bitstream``
    changes no byte by contract and is ignored."""
    if cfg.use_pallas == "off":
        raise NotImplementedError(
            "use_pallas='off' (the scan path) is not ported: ROADMAP A.9"
        )
    if cfg.rate_search == "bisect":
        raise NotImplementedError(
            "rate_search='bisect' is not ported: ROADMAP A.9"
        )
    if cfg.noise_run_window == "gap":
        raise NotImplementedError(
            "noise_run_window='gap' is not ported: ROADMAP A.9"
        )
    if cfg.flat_stream:
        raise NotImplementedError("flat_stream is not ported: ROADMAP A.8")
    _check_transforms(cfg)


def check_decode_supported(cfg: CodecConfig) -> None:
    """The decoder's counterpart of ``check_supported``: the kernel path
    serves P = n_chan * block_size <= 32768 (a record start is 15 bits)."""
    if cfg.use_pallas == "off":
        raise NotImplementedError(
            "use_pallas='off' (the scan decoder) is not ported: ROADMAP A.9"
        )
    if cfg.n_chan * cfg.block_size > 32768:
        raise NotImplementedError(
            f"P = {cfg.n_chan * cfg.block_size} > 32768 (the scan decoder) is not ported: "
            "ROADMAP A.9"
        )
    _check_transforms(cfg)
