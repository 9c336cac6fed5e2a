"""Native (C) host helper: build-on-first-use + ctypes loading.

Port of `fidelityfusion_tpu/utils/native.py`.  The port builds the
repository's `csrc/fastmatch.c` (read, never changed) with the system C
compiler into `build/torch_native/` and loads it with ctypes.  As in the
JAX package, row matching degrades to the numpy implementation when no
compiler is available: this is a host-side data helper, not a device
kernel.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
_SRC = _REPO / "csrc" / "fastmatch.c"
_SO = _REPO / "build" / "torch_native" / "libfastmatch.so"


class _Loader:
    """Compile (once) and load libfastmatch; ``lib`` is None if unavailable."""

    def __init__(self):
        self.tried = False
        self.lib: Optional[ctypes.CDLL] = None

    def get(self) -> Optional[ctypes.CDLL]:
        if self.tried:
            return self.lib
        self.tried = True
        if not _SRC.exists():
            return None
        try:
            if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
                _SO.parent.mkdir(parents=True, exist_ok=True)
                tmp = _SO.with_name(f"libfastmatch.{os.getpid()}.tmp.so")
                cc = os.environ.get("CC", "cc")
                subprocess.run([cc, "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
                               check=True, capture_output=True, timeout=60)
                os.replace(tmp, _SO)
            lib = ctypes.CDLL(str(_SO))
        except (OSError, subprocess.SubprocessError):
            return None
        lib.match_rows.restype = ctypes.c_int
        lib.match_rows.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ]
        self.lib = lib
        return lib


FASTMATCH = _Loader()


def load_fastmatch() -> Optional[ctypes.CDLL]:
    return FASTMATCH.get()


def match_rows_native(x1: np.ndarray, x2: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native exact-row matching; None if the library is unavailable."""
    lib = load_fastmatch()
    if lib is None:
        return None
    x1 = np.ascontiguousarray(np.asarray(x1, np.float64))
    x2 = np.ascontiguousarray(np.asarray(x2, np.float64))
    if x1.ndim != 2 or x2.ndim != 2 or x1.shape[1] != x2.shape[1]:
        return None
    n1, d = x1.shape
    n2 = x2.shape[0]
    out1 = np.zeros(n1, np.uint8)
    out2 = np.zeros(n2, np.uint8)
    rc = lib.match_rows(
        x1.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n1,
        x2.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n2,
        d,
        out1.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out2.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        return None
    return out1.astype(bool), out2.astype(bool)
