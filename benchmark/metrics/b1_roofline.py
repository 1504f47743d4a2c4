"""Kernel B1 (the forward blend) against its least time."""

from benchmark.metrics import _roles


def read(r):
    return _roles.share(r, "B1")
