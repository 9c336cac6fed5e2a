"""Benchmark-data loading over the zoo: subset/non-subset sampling,
fidelity-pair enumeration.

Port of `fidelityfusion_tpu/experiments/load_mfdata.py` over the port's
own `data/zoo.py`, in numpy: the same arrays, bit for bit. Re-design of
`Experiments/Load_Mfdata.py:54-326`: dataset names follow the reference's
fidelity-pair convention — ``forrester12`` means the forrester family's
fidelity 1 vs fidelity 2 (1-based, `Load_Mfdata.py:243-253`). Subset
sampling nests the high-fidelity x inside the low-fidelity x; non-subset
sampling draws them independently (`Load_Mfdata.py:156-221`).
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np

from fidelityfusion_tpu_torch.data.zoo import ZOO


def parse_name(dataset_name: str) -> Tuple[str, int, int]:
    """'forrester12' -> ('forrester', 0, 1) (0-based fidelity indices)."""
    m = re.match(r"([a-zA-Z_]+[0-9]*?)(\d)(\d)$", dataset_name)
    if m is None:
        raise ValueError(f"cannot parse dataset name {dataset_name!r}")
    base, f1, f2 = m.group(1), int(m.group(2)) - 1, int(m.group(3)) - 1
    if base not in ZOO:
        raise KeyError(f"unknown zoo function {base!r} (from {dataset_name!r})")
    return base, f1, f2


def load_data(
    dataset_name: str,
    n_train_low: int = 100,
    n_train_high: int = 32,
    n_test: int = 100,
    seed: int = 0,
    subset: bool = True,
) -> Dict:
    """Sample a 2-fidelity train/test problem from the zoo.

    Returns dict with x_low/y_low/x_high/y_high/x_test/y_test (y_test at
    the HIGH fidelity of the pair).
    """
    base, f_lo, f_hi = parse_name(dataset_name)
    fn, x_dim, n_fid = ZOO[base]
    if max(f_lo, f_hi) >= n_fid:
        raise ValueError(f"{dataset_name}: fidelity out of range (have {n_fid})")
    rng = np.random.default_rng(seed)

    x_low, ys = fn(num_points=n_train_low, seed=seed)
    y_low = ys[f_lo]
    if subset:
        idx = rng.permutation(n_train_low)[:n_train_high]
        x_high = x_low[idx]
        _, ys_h = fn(x=x_high)
        y_high = ys_h[f_hi]
    else:
        x_high, ys_h = fn(num_points=n_train_high, seed=seed + 1)
        y_high = ys_h[f_hi]

    x_test, ys_t = fn(num_points=n_test, seed=seed + 2)
    return {
        "x_low": x_low,
        "y_low": y_low,
        "x_high": x_high,
        "y_high": y_high,
        "x_test": x_test,
        "y_test": ys_t[f_hi],
        "x_dim": x_dim,
    }


def all_fidelity_pairs(base: str) -> List[str]:
    """Enumerate dataset names for every fidelity pair of a zoo family
    (`Load_Mfdata.py:289-326`)."""
    _, _, n_fid = ZOO[base]
    return [
        f"{base}{i+1}{j+1}"
        for i in range(n_fid)
        for j in range(n_fid)
        if i < j
    ]
