"""Training logging, non-finite loss reports and rollback snapshots.

Port of `fidelityfusion_tpu/utils/logging.py`:

* `LogDebugger(method)`: file (DEBUG) and console (INFO) logging into
  ``<log_dir>/<method>/train.log``; `record_stage` ingests a stage's loss
  history from the trainers (``debugger=``; the per-step NaN rollback
  itself is in `train/fit.py`) and logs non-finite losses as errors;
  `save_rollback` writes a parameter snapshot to
  ``rollback_checkpoint.npz``, one array per leaf in `tree_leaves` order.
* `MFGPLog`: the colored console prints.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

import numpy as np

from fidelityfusion_tpu_torch.utils.tree import tree_leaves


def _np(a) -> np.ndarray:
    """A tensor (on any device) or array as numpy."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


class LogDebugger:
    def __init__(self, method: str, log_dir: str = "log", capture_excepthook: bool = True):
        self.method = method
        self.dir = os.path.join(log_dir, method)
        os.makedirs(self.dir, exist_ok=True)
        self.logger = logging.getLogger(f"fidelityfusion.{method}")
        self.logger.setLevel(logging.DEBUG)
        for h in self.logger.handlers:
            h.close()
        self.logger.handlers.clear()
        fh = logging.FileHandler(os.path.join(self.dir, "train.log"))
        fh.setLevel(logging.DEBUG)
        ch = logging.StreamHandler()
        ch.setLevel(logging.INFO)
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
        fh.setFormatter(fmt)
        ch.setFormatter(fmt)
        self.logger.addHandler(fh)
        self.logger.addHandler(ch)
        self.histories = []
        if capture_excepthook:
            # log uncaught exceptions, then hand them to the previous hook
            prev_hook = sys.excepthook

            def hook(exc_type, exc, tb):
                self.logger.error("uncaught exception", exc_info=(exc_type, exc, tb))
                prev_hook(exc_type, exc, tb)

            sys.excepthook = hook

    def record_stage(self, stage: int, losses) -> None:
        """Ingest a stage's loss history (``(steps,)`` or ``(restarts,
        steps)``, a tensor or an array)."""
        arr = _np(losses)
        self.histories.append(arr)
        final = arr.reshape(-1)[-1]
        n_bad = int(np.sum(~np.isfinite(arr)))
        if n_bad:
            self.logger.error("stage %d: %d non-finite losses encountered (rolled back in "
                              "the trainer)", stage, n_bad)
        self.logger.info("stage %d: final loss %.6f", stage, float(final))
        self.logger.debug("stage %d losses: %s", stage, arr.reshape(-1)[-10:])

    def save_rollback(self, params, path: Optional[str] = None) -> str:
        """Write a last-good parameter snapshot: one npz array per leaf, in
        `tree_leaves` order (`utils/checkpoint.py:restore_pytree` reads it
        back given a tree of the same structure)."""
        path = path or os.path.join(self.dir, "rollback_checkpoint.npz")
        np.savez(path, *[_np(leaf) for leaf in tree_leaves(params)])
        self.logger.info("rollback checkpoint saved to %s", path)
        return path


class MFGPLog:
    """ANSI-colored static print wrappers."""

    @staticmethod
    def i(*args):
        print("\033[92m[INFO]\033[0m", *args)

    @staticmethod
    def w(*args):
        print("\033[93m[WARN]\033[0m", *args)

    @staticmethod
    def e(*args):
        print("\033[91m[ERROR]\033[0m", *args)

    @staticmethod
    def d(*args):
        print("[DEBUG]", *args)
