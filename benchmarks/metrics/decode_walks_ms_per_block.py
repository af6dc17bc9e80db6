"""Device milliseconds of the decode walks (``fsm_kernel``, the state
machine with the record placement, and ``rng_kernel``, the noise
expansion; ``csrc/decode_walks.cu``) per decoded block."""

WALKS = ("fsm_kernel", "rng_kernel")


def read(view):
    if view is None or view.params.get("path") != "decode":
        return None
    us = view.kernel_us(*WALKS)
    return us / 1e3 / view.steps if us > 0 else None
