"""The gradient fold's kernel (``csrc/fold_rows.cu``) against its least
time (:func:`benchmark.counts_train.fold_least`: bound by bytes) over the
steps the reference counted, as ``_roles.share`` reads a blend kernel:
the k-th launch in the window is step k's; nothing where the program does
not launch the kernel once a step."""

from benchmark import counts_train


def read(r):
    t = [k[2] for k in r.trace.kernels if counts_train.FOLD_KERNEL in k[0]]
    if not r.frames or len(t) != r.n_frames:
        return None
    dev = sum(t[i] for i in r.frames)
    if dev <= 0:
        return None
    return 100.0 * sum(counts_train.fold_least(f)
                       for f in r.frames.values()) / dev
