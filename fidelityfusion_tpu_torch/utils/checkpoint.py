"""Checkpoint and resume for parameter trees and BO loop state.

Port of `fidelityfusion_tpu/utils/checkpoint.py`, npz only: the JAX
package's orbax branch belongs to a JAX library.  `save_pytree` writes one
npz array per leaf in `tree_leaves` order; `restore_pytree` needs a tree
of the same structure (``like``) to put them back, as the JAX npz branch
does, and returns float tensors on ``like``'s devices.  `save_bo_state`
and `load_bo_state` keep a BO loop's record and datasets (numpy).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from fidelityfusion_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def save_pytree(path: str, tree) -> str:
    """Save a parameter tree (nested dicts, lists and tuples of tensors or
    arrays) to ``path + ".npz"``; returns that path."""
    path = os.path.abspath(path)
    out = path if path.endswith(".npz") else path + ".npz"
    np.savez(out, *[_np(leaf) for leaf in tree_leaves(tree)])
    return out


def restore_pytree(path: str, like):
    """Restore a tree saved by `save_pytree` into the structure of ``like``:
    each leaf a tensor on the device (and of the dtype) of ``like``'s leaf
    at the same place."""
    if like is None:
        raise ValueError("npz restore requires `like` reference tree")
    path = os.path.abspath(path)
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        leaves = [data[k] for k in data.files]
    if len(leaves) != len(tree_leaves(like)):
        raise ValueError(f"{path}: {len(leaves)} arrays for a tree of "
                         f"{len(tree_leaves(like))} leaves")
    restored = tree_unflatten(like, leaves)

    def place(a, ref):
        if torch.is_tensor(ref):
            return torch.as_tensor(a, dtype=ref.dtype).to(ref.device)
        return a

    return tree_map(place, restored, like)


def save_bo_state(path: str, record: Dict[str, Any], xs, ys) -> None:
    """Persist a BO loop's record and datasets for resume."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(
        path,
        record=json.dumps(record),
        **{f"x_{i}": _np(x) for i, x in enumerate(xs)},
        **{f"y_{i}": _np(y) for i, y in enumerate(ys)},
    )


def load_bo_state(path: str):
    with np.load(path, allow_pickle=False) as data:
        record = json.loads(str(data["record"]))
        n = sum(1 for k in data.files if k.startswith("x_"))
        xs = [data[f"x_{i}"] for i in range(n)]
        ys = [data[f"y_{i}"] for i in range(n)]
    return record, xs, ys
