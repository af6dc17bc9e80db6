"""The codec's elementwise and transform ops (port of ``ulcx.ops``), with
the names ulcx's package re-exports."""

from ulcx_torch.ops.fastlog import fast_log  # noqa: F401
from ulcx_torch.ops.dct import dct4, dst4  # noqa: F401
from ulcx_torch.ops.patterns import (  # noqa: F401
    PATTERN_TABLE,
    decimation_pattern,
    pattern_n_subblocks,
    pattern_subblock_shifts,
    pattern_transient_flags,
)
from ulcx_torch.ops.quant import (  # noqa: F401
    companded_quantize,
    companded_quantize_coef,
    companded_quantize_unsigned,
)
