"""The traced segment: a `torch.profiler` trace of a bounded piece of work
run after the measured window, reduced in memory (nothing is written to
disk) to device busy time, kernel times by name, idle gaps by the harness
span in progress, and per-launch shapes of the port's kernels.

The port's kernels are launched through `ctypes`, so their shapes are not
in the trace: while the segment runs, the port's `Library.call` is wrapped
to note each launch's symbol and its ``(B, n)`` arguments in order, and the
i-th device kernel of a symbol's name is matched to its i-th launch.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import re
import time
from typing import Dict, List, Tuple

# device kernels of the port's CUDA libraries, by their names in the trace
KERNEL_NAMES = {"ff_chol_inv": "chol_kernel", "ff_tri_inv": "tri_inv_kernel"}


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    n_kernels: int
    op_seconds: Dict[str, float]  # device time by name
    idle_by_span: Dict[str, float]
    launches: Dict[str, List[Tuple[int, int, float]]]  # symbol -> [(B, n, device s)]
    units: int  # units of work in the segment (the driver's count)

    def breakdown(self) -> dict:
        ops = sorted(self.op_seconds.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:160], v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


@contextlib.contextmanager
def _noted_launches(out: List[Tuple[str, int, int]]):
    from fidelityfusion_tpu_torch.ops import cuda as port_cuda

    orig = port_cuda.Library.call

    def call(self, name, *args):
        if name in KERNEL_NAMES:
            b, n = (getattr(a, "value", a) for a in args[-3:-1])
            out.append((name, int(b), int(n)))
        return orig(self, name, *args)

    port_cuda.Library.call = call
    try:
        yield
    finally:
        port_cuda.Library.call = orig


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _innermost(spans: List[Tuple[str, int, int]], t: int) -> str:
    best, width = "outside any span", None
    for name, s, e in spans:
        if s <= t < e and (width is None or e - s < width):
            best, width = name, e - s
    return best


def summarize(events, t0_ns: int, t1_ns: int, spans, launches, units: int) -> TraceSummary:
    """Reduce kineto events (``prof.profiler.kineto_results.events()``) of a
    segment that ran from ``t0_ns`` to ``t1_ns`` (the trace's clock)."""
    dev = [e for e in events if not str(e.device_type()).endswith("CPU")]
    intervals, by_name = [], collections.defaultdict(float)
    kernels = []
    for e in dev:
        s, d = e.start_ns(), e.duration_ns()
        intervals.append((s, s + d))
        by_name[e.name()] += d * 1e-9
        if not e.name().startswith(("Memcpy", "Memset")):
            kernels.append(e)
    busy = _union(intervals)
    busy_s = sum(e - s for s, e in busy) * 1e-9
    # idle gaps inside the segment, by the innermost harness span at their start
    idle = collections.defaultdict(float)
    cursor = t0_ns
    for s, e in busy + [(t1_ns, t1_ns)]:
        if s > cursor:
            idle[_innermost(spans, cursor)] += (min(s, t1_ns) - cursor) * 1e-9
        cursor = max(cursor, e)
    # the port's kernels, matched in launch order
    kernels.sort(key=lambda e: e.start_ns())
    matched = {}
    for symbol, kname in KERNEL_NAMES.items():
        pat = re.compile(rf"(^|[\s:]){kname}\(")
        evs = [e for e in kernels if pat.search(e.name())]
        shapes = [(b, n) for sym, b, n in launches if sym == symbol]
        if len(evs) == len(shapes):
            matched[symbol] = [(b, n, e.duration_ns() * 1e-9) for (b, n), e in zip(shapes, evs)]
    return TraceSummary(window_s=(t1_ns - t0_ns) * 1e-9, busy_s=busy_s, n_kernels=len(kernels),
                        op_seconds=dict(by_name), idle_by_span=dict(idle), launches=matched,
                        units=units)


def profile_segment(run, work) -> TraceSummary:
    """Run ``work()`` (which returns the number of units it ran) under
    `torch.profiler` with CPU and CUDA activities and reduce the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    launches: List[Tuple[str, int, int]] = []
    n_spans = len(run.spans)
    run.sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if run.device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with record_function("portbench.clock"):
            clock_ns = time.time_ns()
        t0 = time.time_ns()
        with _noted_launches(launches):
            units = work()
        run.sync()
        t1 = time.time_ns()
    events = prof.profiler.kineto_results.events()
    marker = next(e for e in events if e.name() == "portbench.clock")
    off = marker.start_ns() - clock_ns
    spans = [(name, s + off, e + off) for name, s, e in run.spans[n_spans:]]
    return summarize(events, t0 + off, t1 + off, spans, launches, units)
