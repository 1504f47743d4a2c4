"""Kernel B2 (the backward blend) against its least time, over the steps
the reference counted."""

from benchmark.metrics import _roles


def read(r):
    return _roles.share(r, "B2")
