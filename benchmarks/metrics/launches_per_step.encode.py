"""Device kernels launched per encode block step (of the whole batch),
counted in the profiler's timeline of the traced calls: the host
dispatch the encode driver pays for each block."""


def read(view):
    if view is None or view.params.get("path") != "encode" or not view.kernels:
        return None
    return len(view.kernels) / view.steps
