"""Build, load and count the hand-written CUDA kernels.

Route: each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a
shared library with a plain C interface and loaded with `ctypes` (no
PyTorch headers, so a build takes seconds).  Libraries are built at first
use into `build/torch_kernels/` at the root of the checkout, named by a
hash of their source and of every header in `csrc/`, so an edited source
or header is rebuilt and an unchanged one is reused.  Nothing is built or
loaded when this module is imported.

Every C entry point returns a `cudaError_t` (0 on success);
`Library.call` turns a non-zero code into an exception.  Each kernel wrapper owns a
`LaunchCounter` from `counter(...)` and adds one to it where it launches
its kernel, so a run can show which kernels its main path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

PTR = ctypes.c_void_p
INT = ctypes.c_int
I64 = ctypes.c_longlong


def nvcc_path() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (looked in CUDA_HOME, /usr/local/cuda, PATH)")


class Library:
    """One `.cu` source, compiled to one shared library on first use."""

    def __init__(self, source: str, symbols: Dict[str, List]):
        self.source = CSRC / source
        self.symbols = symbols  # C function name -> argtypes
        self._handle: Optional[ctypes.CDLL] = None

    def so_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def build_command(self, out: Path, verbose: bool = False) -> List[str]:
        flags = NVCC_FLAGS + (["-Xptxas=-v"] if verbose else [])
        return [nvcc_path(), *flags, "-I", str(CSRC), "-o", str(out),
                str(self.source)]

    def handle(self) -> ctypes.CDLL:
        if self._handle is None:
            build([self])
            lib = ctypes.CDLL(str(self.so_path()))
            for name, argtypes in self.symbols.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ff_error_string.argtypes = [ctypes.c_int]
            lib.ff_error_string.restype = ctypes.c_char_p
            self._handle = lib
        return self._handle

    def call(self, name: str, *args) -> None:
        """Run one C entry point and raise on a non-zero `cudaError_t`."""
        lib = self.handle()
        rc = getattr(lib, name)(*args)
        if rc != 0:
            msg = lib.ff_error_string(rc).decode()
            raise RuntimeError(f"{self.source.name}:{name} failed: CUDA error {rc} ({msg})")


def build(libs: Iterable[Library], verbose: bool = False) -> str:
    """Compile every library whose `.so` is missing, one `nvcc` each, all
    started together.  Returns the compilers' combined output (with
    ``verbose``, `ptxas` register and spill reports)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for lib in libs:
        out = lib.so_path()
        if out.exists() and not verbose:
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        procs.append((lib, out, tmp, subprocess.Popen(
            lib.build_command(tmp, verbose), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    report, failed = [], []
    for lib, out, tmp, p in procs:
        text, _ = p.communicate(timeout=900)
        report.append(f"== {lib.source.name}\n{text}")
        if p.returncode != 0:
            failed.append(f"{lib.source.name}:\n{text}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return "\n".join(report)


class LaunchCounter:
    """Plain integer count of a wrapper's kernel launches."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


COUNTERS: Dict[str, LaunchCounter] = {}


def counter(name: str) -> LaunchCounter:
    return COUNTERS.setdefault(name, LaunchCounter(name))


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: c.launches for name, c in COUNTERS.items()}


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors, dtype=torch.float32) -> None:
    """Raise unless every tensor is a contiguous ``dtype`` tensor on one
    CUDA device (what the kernels take: float32, and K1 also float64)."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        if t.dtype != dtype:
            raise ValueError(f"{name}: the kernel takes {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
