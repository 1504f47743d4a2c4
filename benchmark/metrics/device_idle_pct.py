"""Share of the traced window in which no kernel, memcpy or memset ran on
the device."""


def read(r):
    if not r.trace.kernels or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
