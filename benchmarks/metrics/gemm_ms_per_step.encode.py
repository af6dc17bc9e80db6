"""Device milliseconds of the float32 GEMMs (every kernel whose name
holds "gemm": the analysis transforms of ``ops.dct`` and the EMA
products of window control) per encode block step."""


def read(view):
    if view is None or view.params.get("path") != "encode":
        return None
    us = view.gemm_us()
    return us / 1e3 / view.steps if us > 0 else None
