"""Kernel launches a unit of work (a step, a frame or a view), counted from
the device trace's kernel events."""


def read(r):
    if not r.trace.kernels or not r.units:
        return None
    return len(r.trace.kernels) / r.units
