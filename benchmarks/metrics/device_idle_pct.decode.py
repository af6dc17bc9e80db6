"""Share of the traced decode calls' window in which nothing ran on the
device: 100 x (1 - the union of every kernel's, copy's and set's
interval / the window), from the profiler's timeline. Nothing where
no operation ran on the device."""


def read(view):
    if view is None or view.params.get("path") != "decode" or view.busy_us <= 0:
        return None
    return 100.0 * (1.0 - view.busy_us / view.window_us)
