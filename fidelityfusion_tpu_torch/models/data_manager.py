"""Multi-fidelity data management: normalizers + subset/non-subset alignment.

Port of `fidelityfusion_tpu/models/data_manager.py`.  All set logic
(overlap / unique row matching) runs in numpy on the host at
dataset-build time; the arrays it produces are moved to the model's device
by the trainers.  The one device call is the imputation of missing
low-fidelity rows, which runs the model's own prediction cascade.

API mirrors the reference so that model/training code reads the same:
  add_data, get_data, get_data_by_name, get_overlap_input_data,
  get_unique_input_data, get_nonsubset_fill_data, display_fidelity_data_info.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

EPS = 1e-10


class Normalizer:
    """Per-fidelity x/y mean-std normalization (`MF_data.py:9-73`).

    normal_y_mode 0: normalize y over all elements; 1: per output column.
    Fitted from the *first* batch only (matching `MF_data.py:134-135`).
    """

    def __init__(self, x, y, normal_x_dim: int = 0, normal_y_mode: int = 0):
        import warnings

        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        with np.errstate(invalid="ignore", divide="ignore"), \
                warnings.catch_warnings():
            # single-row fits: ddof=1 emits "Degrees of freedom <= 0" and
            # produces NaN — _safe_std replaces it with identity scale
            warnings.simplefilter("ignore", RuntimeWarning)
            self.x_mean = x.mean(axis=normal_x_dim)
            self.x_std = self._safe_std(
                x.std(axis=normal_x_dim, ddof=1), self.x_mean
            )
            if normal_y_mode == 0:
                self.y_mean = y.mean()
                self.y_std = self._safe_std(y.std(ddof=1), self.y_mean)
            else:
                self.y_mean = y.mean(axis=0)
                self.y_std = self._safe_std(
                    y.std(axis=0, ddof=1), self.y_mean
                )

    @staticmethod
    def _safe_std(s, mean=0.0):
        """ddof=1 std is NaN for a single row and 0 for constant columns —
        either poisons every later (de)normalization (the reference's
        torch `std()` NaNs the same way, `MF_data.py:30-37`).  Identity
        scale is the only safe degenerate choice.  The degeneracy
        threshold is RELATIVE to the data's own magnitude, so a
        legitimately tiny-but-nonzero scale (e.g. data in 1e-15 units)
        still normalizes instead of silently passing through; a warning
        flags any column the guard actually fires on."""
        import warnings

        s = np.asarray(s, np.float64)
        tiny = s * 0.0 + 1e-12 * np.maximum(
            1.0, np.abs(np.asarray(mean, np.float64))
        )
        bad = ~np.isfinite(s) | (s < tiny)
        if np.any(bad):
            warnings.warn(
                "Normalizer: degenerate std (single row or constant "
                "column) replaced by identity scale", UserWarning,
                stacklevel=3,
            )
        fixed = np.where(bad, 1.0, s)
        return fixed if fixed.ndim else float(fixed)

    def normalize(self, x, y):
        return self.normalize_x(x), self.normalize_y(y)

    def normalize_x(self, x):
        return (np.asarray(x) - self.x_mean) / (self.x_std + EPS)

    def normalize_y(self, y):
        return (np.asarray(y) - self.y_mean) / (self.y_std + EPS)

    def denormalize(self, mean, var):
        """Denormalize posterior mean and (co)variance; var scales by std^2
        (`MF_data.py:60-73`)."""
        mean = np.asarray(mean) * self.y_std + self.y_mean
        var = np.asarray(var) * (self.y_std**2)
        return mean, var


def pair_rows(x1: np.ndarray, x2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Index arrays (idx1, idx2) pairing each row of x2 that exactly
    appears in x1 with the FIRST matching row of x1, in x2's row order.

    This is the alignment `get_overlap_input_data` needs: selecting the
    two sides with independent boolean masks (the reference's approach,
    `MF_data.py:196-205`) silently mispairs y1 with y2 whenever the
    high-fidelity design is not an order-preserving subset of the
    low-fidelity one (permuted subsets), and produces mismatched row
    COUNTS once duplicate designs exist (a BO loop re-querying an x).
    """
    x1 = np.ascontiguousarray(np.asarray(x1, np.float64))
    x2 = np.ascontiguousarray(np.asarray(x2, np.float64))
    if x1.size == 0 or x2.size == 0:
        return np.zeros(0, np.intp), np.zeros(0, np.intp)
    first = {}
    for i, row in enumerate(x1):
        first.setdefault(row.tobytes(), i)
    idx1, idx2 = [], []
    for j, row in enumerate(x2):
        i = first.get(row.tobytes())
        if i is not None:
            idx1.append(i)
            idx2.append(j)
    return np.asarray(idx1, np.intp), np.asarray(idx2, np.intp)


def match_rows(x1: np.ndarray, x2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Boolean masks of rows of x1 present in x2 and vice versa.

    Vectorized exact-row matching, the semantics of `MF_data.py:196-205`
    (and legacy `subset_tools.py:72-90`), done via lexicographic row views
    in O((n1+n2) log(n1+n2) * d) instead of the reference's O(n1*n2*d)
    broadcast.
    """
    x1 = np.ascontiguousarray(np.asarray(x1, np.float64))
    x2 = np.ascontiguousarray(np.asarray(x2, np.float64))
    if x1.size == 0 or x2.size == 0:
        return np.zeros(len(x1), bool), np.zeros(len(x2), bool)
    # native C path (csrc/fastmatch.c) with numpy structured-view fallback
    from fidelityfusion_tpu_torch.utils.native import match_rows_native

    native = match_rows_native(x1, x2)
    if native is not None:
        return native
    v1 = x1.view([("", x1.dtype)] * x1.shape[1]).ravel()
    v2 = x2.view([("", x2.dtype)] * x2.shape[1]).ravel()
    return np.isin(v1, v2), np.isin(v2, v1)


class MultiFidelityDataManager:
    """Dictionary-of-fidelities container (`MF_data.py:76-325`).

    Entries are keyed by ``raw_fidelity_name``; each holds
    ``{fidelity_index, X, Y}`` where Y may be an array or a
    ``[mean, var]`` pair (derived residual datasets).  A Normalizer is
    created per *fidelity index* from the first batch added.
    """

    def __init__(self, initial_data: Optional[List[dict]] = None):
        self.data_dict: Dict[str, dict] = {}
        self.normalizelayer: Dict[int, Normalizer] = {}
        if initial_data is not None:
            for d in initial_data:
                self.add_data(
                    d["raw_fidelity_name"], d["fidelity_indicator"], d["X"], d["Y"]
                )

    @staticmethod
    def _to_np(a):
        if isinstance(a, (list, tuple)):
            return [None if x is None else np.asarray(x) for x in a]
        return None if a is None else np.asarray(a)

    def add_data(self, raw_fidelity_name: str, fidelity_index: Optional[int], x, y):
        x = self._to_np(x)
        y = self._to_np(y)
        if raw_fidelity_name not in self.data_dict:
            self.data_dict[raw_fidelity_name] = {
                "fidelity_index": fidelity_index,
                "X": x,
                "Y": y,
            }
        else:
            entry = self.data_dict[raw_fidelity_name]
            entry["X"] = np.concatenate([entry["X"], x])
            if isinstance(entry["Y"], list):
                entry["Y"] = [
                    None if a is None else np.concatenate([a, b])
                    for a, b in zip(entry["Y"], y)
                ]
            else:
                entry["Y"] = np.concatenate([entry["Y"], y])
        if fidelity_index is not None and fidelity_index not in self.normalizelayer:
            y_for_norm = y[0] if isinstance(y, list) else y
            self.normalizelayer[fidelity_index] = Normalizer(x, y_for_norm)

    def get_data(self, fidelity_index: int, normal: bool = True):
        for data in self.data_dict.values():
            if data["fidelity_index"] == fidelity_index:
                if normal and fidelity_index in self.normalizelayer:
                    return self.normalizelayer[fidelity_index].normalize(
                        data["X"], data["Y"]
                    )
                return data["X"], data["Y"]
        return None, None

    def get_data_by_name(self, raw_fidelity_name: str, normal: bool = True):
        if raw_fidelity_name not in self.data_dict:
            return None, None
        entry = self.data_dict[raw_fidelity_name]
        fi = entry["fidelity_index"]
        if normal and fi in self.normalizelayer:
            return self.normalizelayer[fi].normalize(entry["X"], entry["Y"])
        return entry["X"], entry["Y"]

    def get_overlap_input_data(
        self, fidelity_index1: int, fidelity_index2: int, normal: bool = False
    ):
        """Rows of fidelity-1 inputs that also appear in fidelity-2, and
        vice versa (`MF_data.py:177-213`)."""
        x1, y1 = self.get_data(fidelity_index1, normal=False)
        x2, y2 = self.get_data(fidelity_index2, normal=False)
        if x1 is None or x2 is None:
            return None, None, None, None
        # PAIRED selection in fidelity-2 row order: row i of (cx1, cy1)
        # is the fidelity-1 observation at the same x as row i of
        # (cx2, cy2) — mask-based selection (the reference's) mispairs
        # permuted subsets and breaks on duplicate designs (see pair_rows)
        idx1, idx2 = pair_rows(x1, x2)
        cx1, cy1 = x1[idx1], y1[idx1]
        cx2, cy2 = x2[idx2], y2[idx2]
        if (
            normal
            and fidelity_index1 in self.normalizelayer
            and fidelity_index2 in self.normalizelayer
        ):
            cx1, cy1 = self.normalizelayer[fidelity_index1].normalize(cx1, cy1)
            cx2, cy2 = self.normalizelayer[fidelity_index2].normalize(cx2, cy2)
        return cx1, cy1, cx2, cy2

    def get_unique_input_data(
        self, fidelity_index1: int, fidelity_index2: int, normal: bool = False
    ):
        """Complement of the overlap (`MF_data.py:215-251`)."""
        x1, y1 = self.get_data(fidelity_index1, normal=False)
        x2, y2 = self.get_data(fidelity_index2, normal=False)
        if x1 is None or x2 is None:
            return None, None, None, None
        m1, m2 = match_rows(x1, x2)
        ux1, uy1 = x1[~m1], y1[~m1]
        ux2, uy2 = x2[~m2], y2[~m2]
        if (
            normal
            and fidelity_index1 in self.normalizelayer
            and fidelity_index2 in self.normalizelayer
        ):
            ux1, uy1 = self.normalizelayer[fidelity_index1].normalize(ux1, uy1)
            ux2, uy2 = self.normalizelayer[fidelity_index2].normalize(ux2, uy2)
        return ux1, uy1, ux2, uy2

    def get_nonsubset_fill_data(self, model, fidelity_index1: int, fidelity_index2: int):
        """Impute missing low-fidelity observations for non-subset training
        (`MF_data.py:253-303`).

        For high-fidelity points without a low-fidelity observation, the
        low-fidelity y is *imputed* by the model's own prediction cascade
        (an explicit staged computation here: fidelities < i are already
        trained when this runs).  Returns
        ``(x, [y_low_mean, y_low_var], [y_high_mean, y_high_var])`` where
        vars are per-row variance *vectors* (the reference builds full
        matrices but only their diagonal ever enters the likelihood).
        Observed rows get zero variance; imputed rows the predictive one.
        """
        sx1, sy1, sx2, sy2 = self.get_overlap_input_data(fidelity_index1, fidelity_index2)
        ux1, uy1, ux2, uy2 = self.get_unique_input_data(fidelity_index1, fidelity_index2)

        norm1 = self.normalizelayer[fidelity_index1]
        norm2 = self.normalizelayer[fidelity_index2]
        sy1 = norm1.normalize_y(sy1)
        ux2_raw = ux2  # model.forward takes RAW x
        sx2, sy2 = norm2.normalize(sx2, sy2)
        ux2, uy2 = norm2.normalize(ux2, uy2)

        def _fill(x_units_raw, template):
            # imputed in fidelity_index1's normalized-y space (the space the
            # residual target subtracts in); ``template`` fixes the per-sample
            # output shape (vector vs tensor fields)
            with torch.no_grad():
                mean, var = model.forward(
                    self,
                    np.asarray(x_units_raw, np.float32),
                    to_fidelity=fidelity_index1,
                    denormalize=False,
                )
            mean = mean.cpu().numpy()
            var = var.cpu().numpy()
            if var.ndim == 2 and var.shape[0] == var.shape[1] and var.shape[0] == mean.shape[0]:
                var_diag = np.diagonal(var).copy()
            else:
                var_diag = var.reshape(var.shape[0], -1).mean(axis=-1)
            mean = mean.reshape((len(x_units_raw),) + template.shape[1:])
            return mean, var_diag

        if len(sx2) == 0:  # full non-subset
            # template = LOW-fidelity per-sample shape (the imputed values
            # live on fidelity_index1's output grid, which differs from
            # uy2's grid for non-aligned tensor fields)
            _, y1_all = self.get_data(fidelity_index1)
            fill_mean, fill_var = _fill(ux2_raw, np.asarray(y1_all))
            y_high_var = np.zeros(len(uy2))
            return (
                ux2,
                [fill_mean, fill_var],
                [uy2, y_high_var],
            )
        elif len(ux2) == 0:  # full subset
            return (
                sx2,
                [sy1, np.zeros(len(sy1))],
                [sy2, np.zeros(len(sy2))],
            )
        else:  # mixed
            fill_mean, fill_var = _fill(ux2_raw, sy1)
            y_low_mean = np.concatenate([sy1, fill_mean], axis=0)
            y_low_var = np.concatenate([np.zeros(len(sy1)), fill_var])
            y_high_mean = np.concatenate([sy2, uy2], axis=0)
            y_high_var = np.zeros(len(y_high_mean))
            x = np.concatenate([sx2, ux2], axis=0)
            return x, [y_low_mean, y_low_var], [y_high_mean, y_high_var]

    def display_fidelity_data_info(self, fidelity_index: int):
        for name, data in self.data_dict.items():
            if data["fidelity_index"] == fidelity_index:
                print("<---------Fidelity data information:--------->")
                print(f"Fidelity index: {fidelity_index}")
                print(f"Fidelity name: {name}")
                print(f"data_num: {len(data['X'])}")
                print(f"X_shape: {np.shape(data['X'])}")
                y = data["Y"][0] if isinstance(data["Y"], list) else data["Y"]
                print(f"Y_shape: {np.shape(y)}")
