"""Checkpoint / resume (counterpart of ``gsplat_tpu.utils.checkpoint``).

Two complementary formats, as in the JAX package:

1. **PLY** stays the canonical portable scene checkpoint (with the ``label``
   property), see ``gsplat_tpu_torch.io.ply``.
2. **Training state and vote accumulators** go through ``torch.save`` /
   ``torch.load(weights_only=True)``: a nested structure of dicts and
   NamedTuples (``TrainState``, ``AdamState``, ``SceneParams``,
   ``DensifyStats``) is flattened into one plain dict keyed by dotted paths
   (``"state.params.means"``), whose leaves are tensors, ints and floats.
   ``weights_only`` loading refuses NamedTuples, so ``restore_pytree`` takes
   the structure from ``like``.

The JAX package writes orbax checkpoints; orbax needs jax, so the port
neither reads nor writes them. A save goes to a temporary file in the
target's directory and is moved into place with ``os.replace``, so an
interrupted save leaves the previous checkpoint whole, as orbax's does.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

_SEP = "."


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Optional[Dict[str, Any]]:
    """The named children of a dict or NamedTuple; None for a leaf."""
    if isinstance(tree, dict):
        return {str(k): v for k, v in tree.items()}
    if _is_namedtuple(tree):
        return dict(zip(tree._fields, tree))
    return None


def _flatten(tree, prefix: str, out: Dict[str, Any]) -> None:
    kids = _children(tree)
    if kids is None:
        if isinstance(tree, (np.ndarray, np.generic)):
            tree = torch.from_numpy(np.asarray(tree))
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu()
        elif not isinstance(tree, (bool, int, float)):
            raise TypeError(f"checkpoint leaf {prefix!r} is a "
                            f"{type(tree).__name__}; tensors, arrays, ints "
                            "and floats only")
        out[prefix] = tree
        return
    for k, v in kids.items():
        if _SEP in k:
            raise ValueError(f"checkpoint key {k!r} holds {_SEP!r}")
        _flatten(v, f"{prefix}{_SEP}{k}" if prefix else k, out)


def save_pytree(path: str, tree: Any) -> None:
    """Save a nested structure of dicts and NamedTuples whose leaves are
    tensors, numpy arrays, ints or floats (tensors are saved from the
    host), atomically."""
    flat: Dict[str, Any] = {}
    _flatten(tree, "", flat)
    path = os.path.abspath(path)
    directory = os.path.dirname(path)
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory,
                               prefix=f".{os.path.basename(path)}.")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(flat, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, leaf in flat.items():
        node = out
        *parents, last = key.split(_SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


def _rebuild(like, flat: Dict[str, Any], prefix: str, used: set):
    kids = _children(like)
    if kids is None:
        if prefix not in flat:
            raise KeyError(f"checkpoint has no {prefix!r}")
        used.add(prefix)
        leaf = flat[prefix]
        if isinstance(like, torch.Tensor):
            if not isinstance(leaf, torch.Tensor) or (
                    leaf.shape != like.shape or leaf.dtype != like.dtype):
                raise ValueError(
                    f"checkpoint {prefix!r} is {_describe(leaf)}, expected "
                    f"{_describe(like)}")
            return leaf.to(like.device)
        return type(like)(leaf)
    built = {k: _rebuild(v, flat, f"{prefix}{_SEP}{k}" if prefix else k,
                         used)
             for k, v in kids.items()}
    if isinstance(like, dict):
        return {k: built[str(k)] for k in like}
    return type(like)(**built)


def _describe(x) -> str:
    if isinstance(x, torch.Tensor):
        return f"a {x.dtype} tensor of shape {tuple(x.shape)}"
    return type(x).__name__


def restore_pytree(path: str, like: Optional[Any] = None) -> Any:
    """Restore what :func:`save_pytree` saved. Without ``like``: nested
    dicts of its leaves. With ``like`` (the structure saved, e.g. the
    payload a fresh run builds): the same structure, NamedTuples included,
    each tensor on the device of ``like``'s tensor at its place; a missing,
    extra or differently shaped leaf raises."""
    flat = torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)
    if like is None:
        return _unflatten(flat)
    used: set = set()
    out = _rebuild(like, flat, "", used)
    extra = sorted(set(flat) - used)
    if extra:
        raise ValueError(f"checkpoint holds leaves the structure lacks: "
                         f"{extra}")
    return out


class VoteCheckpoint:
    """Resumable majority-vote sweep: persists the vote histogram and the
    index of the next view to process. ``load`` gives the histogram as a
    numpy array, which ``label.vote.assign_labels(initial_votes=...)``
    takes."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)

    def _path(self) -> str:
        return os.path.join(self.directory, "votes")

    def save(self, votes, next_view: int) -> None:
        if not isinstance(votes, torch.Tensor):
            votes = np.asarray(votes)
        save_pytree(self._path(), {"votes": votes,
                                   "next_view": int(next_view)})

    def load(self):
        if not os.path.exists(self._path()):
            return None, 0
        d = restore_pytree(self._path())
        return d["votes"].numpy(), int(d["next_view"])
