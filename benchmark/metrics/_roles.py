"""Shared by the roofline readers: a kernel role's share of its least time
over the frames the reference counted."""

from benchmark import counts


def share(r, role, least=counts.blend_least):
    """``least(role, frame)`` summed over ``r.frames``, over the device
    seconds of those frames' launches of the role's kernel, in %. The k-th
    launch in the window is frame k's; None where the role does not launch
    once a frame, or no frame was counted."""
    sym = counts.KERNELS[role]
    t = [k[2] for k in r.trace.kernels if sym in k[0]]
    if not r.frames or len(t) != r.n_frames:
        return None
    dev = sum(t[i] for i in r.frames)
    if dev <= 0:
        return None
    return 100.0 * sum(least(role, f) for f in r.frames.values()) / dev
