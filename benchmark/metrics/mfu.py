"""The whole window's least time at the published peaks (its blend kernels'
least time plus the bytes each unit must move once) over its traced
time."""


def read(r):
    if not r.trace.kernels or not r.step_least or r.trace.window_s <= 0:
        return None
    return 100.0 * r.step_least / r.trace.window_s
