"""Kernel B5 (the visibility blend) against its least time, over the views
the check's reference counted."""

from benchmark.metrics import _roles


def read(r):
    return _roles.share(r, "B5")
