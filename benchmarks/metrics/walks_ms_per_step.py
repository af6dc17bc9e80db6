"""Device milliseconds of the encode walks (``p1_kernel``,
``p2_kernel``, ``p3_kernel``, ``csrc/encode_walks.cu``) per encode block
step."""

WALKS = ("p1_kernel", "p2_kernel", "p3_kernel")


def read(view):
    if view is None or view.params.get("path") != "encode":
        return None
    us = view.kernel_us(*WALKS)
    return us / 1e3 / view.steps if us > 0 else None
