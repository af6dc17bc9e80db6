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


def check_supported(cfg: CodecConfig) -> None:
    """Raise NotImplementedError for settings this port does not serve
    yet, naming the ROADMAP item that will. ``fold_bitstream`` changes
    no byte by contract and is ignored."""
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
    for ss in cfg.subblock_sizes:
        backend = cfg.transform_for(ss)
        if backend != "matmul" or ss > cfg.matmul_max_n:
            raise NotImplementedError(
                f"transform backend {backend!r} (subblock {ss} with "
                f"matmul_max_n={cfg.matmul_max_n}) is not ported: ROADMAP A.7"
            )
