"""Device milliseconds of the GEMMs (every kernel whose name holds
"gemm": the inverse transforms of ``codec.transform_batched``) per
decoded block."""


def read(view):
    if view is None or view.params.get("path") != "decode":
        return None
    us = view.gemm_us()
    return us / 1e3 / view.steps if us > 0 else None
