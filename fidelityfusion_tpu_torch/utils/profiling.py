"""Profiling and timing hooks.

Port of `fidelityfusion_tpu/utils/profiling.py`: a stopwatch registry
feeding the experiments' time columns, a `torch.profiler` trace capture,
and the chain-difference timer of one operation (`device_time`).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict

import torch


class Stopwatch:
    """Accumulating named timers (host clock)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def measure(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def rate(self, name: str) -> float:
        """Events per second for a named timer."""
        return self.counts[name] / self.totals[name] if self.totals[name] else 0.0

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k],
                "mean_s": self.totals[k] / max(self.counts[k], 1)}
            for k in self.totals
        }


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """Capture a `torch.profiler` trace of the block (host, and the card's
    kernels where CUDA is available) into ``logdir`` as a TensorBoard /
    Chrome trace; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def device_time(fn_factory: Callable[[int], Callable], L1: int = 2, L2: int = 12,
                reps: int = 3) -> float:
    """Seconds per operation by the chain-difference method:
    ``fn_factory(L)`` returns a nullary function that runs the operation L
    times and returns a tensor.  Each chain is called once to warm up, then
    ``reps`` times; the difference of the two chains' mean times over
    ``L2 - L1`` cancels the per-call overhead.  Where the warm-up result
    lies on a CUDA device the chains are timed by CUDA events after a
    synchronize (stream time: the device's, unless enqueueing an operation
    takes longer than running it), otherwise by the host clock."""
    f1, f2 = fn_factory(L1), fn_factory(L2)
    out = f1()
    f2()
    on_cuda = torch.is_tensor(out) and out.is_cuda

    def t(f):
        if on_cuda:
            torch.cuda.synchronize(out.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                f()
            end.record()
            torch.cuda.synchronize(out.device)
            return start.elapsed_time(end) / 1e3 / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            f()
        return (time.perf_counter() - t0) / reps

    return (t(f2) - t(f1)) / (L2 - L1)
