"""Device kernels launched per decoded block (of the whole batch),
counted in the profiler's timeline of the traced calls."""


def read(view):
    if view is None or view.params.get("path") != "decode" or not view.kernels:
        return None
    return len(view.kernels) / view.steps
