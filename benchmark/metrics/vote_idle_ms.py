"""Milliseconds a unit of work (a view or a frame) in which the device idled
while the host was inside the ``gsplat.vote`` span: the vote
(``label/vote.py``: ``_vote_histogram`` and ``votes_to_labels``)."""

from benchmark.metrics import _spans


def read(r):
    return _spans.idle_ms(r, "vote")
