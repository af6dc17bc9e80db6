"""The decode walks' share of their memory roofline: the least time the
card could take to move the bytes a decoded block needs, at 3.35 TB/s
(one H100 SXM's HBM3, NVIDIA's data sheet), over the device time of
``fsm_kernel`` and ``rng_kernel`` per decoded block.

The bytes: the state machine reads each stream's window control and
tokens and writes its expansion flags [P, B] with the consumed count and
corrupt flag; the expansion reads the flags and the RNG state and writes
the coefficients [P, B] and the new state. The tokens are counted in the
port's layout, 2 W - 2 nybbles of a W-byte window at one 32-bit word
each (8 W bytes where the window itself is W), so that the count matches
the kernel table's; a count of the window's own bytes would give a bound
about 10 % lower at the decode cell's sizes (B = 8192, P = 4096, W =
832), and this share that much lower (PERF.md).
"""

HBM_BYTES_PER_S = 3.35e12
WALKS = ("fsm_kernel", "rng_kernel")


def block_bytes(batch: int, positions: int, window_bytes: int) -> dict:
    plane = positions * batch * 4
    return {
        "fsm_place": batch * 4 + (2 * window_bytes - 2) * batch * 4 + plane + 2 * batch * 4,
        "rng_expand": plane + batch * 4 + plane + batch * 4,
    }


def read(view):
    if view is None or view.params.get("path") != "decode":
        return None
    us = view.kernel_us(*WALKS)
    if us <= 0:
        return None
    p = view.params
    bound_s = sum(block_bytes(p["streams"], p["positions"], p["window_bytes"]).values()) / HBM_BYTES_PER_S
    return 100.0 * bound_s / (us / 1e6 / view.steps)
