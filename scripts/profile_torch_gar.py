#!/usr/bin/env python3
"""Host calls, syncs and device kernels of one GAR fit of the benchmark's
`gar.fit-poisson-2048` cell, under `torch.profiler`.

    python3 scripts/profile_torch_gar.py [--seed N] [--out FILE]

Builds the cell's data and model as `portbench/drivers/fit_gar.py` does
(Poisson fields on nested 2048/1024/512 rows, 4 restarts x 100 steps),
warms up with the cell's own set-up, then profiles one whole fit
(`train_GAR` and `GAR.forward`).  Prints the card's name and power limit,
the fit's wall and stage walls, the host-side calls that pace it
(`aten::_linalg_eigh`, `cudaStreamSynchronize`, `cudaMemcpyAsync`: count
and total milliseconds), `ops/spectral.py:spectral_counts()` of the fit,
the kernel wrappers' launch counts, the training steps captured into and
replayed from CUDA graphs (`train/fit.py:graph_counts`), the host's
launch calls (kernels, copies, sets and graph launches) and the device's
kernels per training step, the device's busy time and idle share, the
cuSOLVER reduction kernels by the matrix size their template names
(`sytrd_params<double, _, _, n, ...>`), and the kernels by device time;
``--out`` also receives the full tables.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import re
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HOST_CALLS = ("aten::_linalg_eigh", "cudaStreamSynchronize", "cudaMemcpyAsync")
# host calls that put work on a stream
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
                "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
                "cudaGraphLaunch")
REDUCTION = re.compile(r"sytrd_params<double, \d+, \d+, (\d+),")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=1234567)
    parser.add_argument("--out", type=Path, default=None, help="file for the full tables")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_gar: torch.cuda.is_available() is False; needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    from portbench.drivers import fit_gar
    from profile_torch_ar import busy_us, device_events
    from chip_smoke import smi_line
    from fidelityfusion_tpu_torch.ops import cuda, spectral
    from fidelityfusion_tpu_torch.train import fit as trainer

    cell = "gar.fit-poisson-2048"
    wl = harness.workload(cell)
    run = harness.Run(cell, args.seed, 0.0, True, wl, harness.config(wl["config"]),
                      harness.traffic(wl["traffic"]), device=torch.device("cuda", 0))
    torch.backends.cuda.matmul.allow_tf32 = False
    state = fit_gar.setup(run)  # builds the kernels and warms this cell's shapes
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    cuda.reset_launch_counts()
    spectral.reset_spectral_counts()
    trainer.reset_graph_counts()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fit_gar.fit(run, state, 0, run.traffic["steps"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = spectral.spectral_counts()
    events = device_events(prof, torch)
    busy = busy_us([(s, e) for _, s, e in events]) * 1e-6
    host = defaultdict(lambda: [0, 0.0])
    launches = 0
    for e in prof.events():
        if e.name in HOST_CALLS:
            host[e.name][0] += 1
            host[e.name][1] += (e.time_range.end - e.time_range.start) * 1e-3
        launches += e.name in LAUNCH_CALLS
    steps = len(run.traffic["rows"]) * run.traffic["steps"]  # training steps of the fit
    by_name = defaultdict(lambda: [0, 0.0])
    for name, s, e in events:
        by_name[name][0] += 1
        by_name[name][1] += (e - s) * 1e-3
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    reduction = defaultdict(lambda: [0, 0.0])
    for name, (count, ms) in rows:
        m = REDUCTION.search(name)
        if m:
            reduction[int(m.group(1))][0] += count
            reduction[int(m.group(1))][1] += ms

    print(f"{smi_line()}  torch {torch.__version__}")
    print(f"fit: wall {wall:.4f} s (profiled)  stages {[round(s, 4) for s in out['stage_s']]} s")
    for name in HOST_CALLS:
        count, ms = host[name]
        print(f"host {name}: {count} calls, {ms:.1f} ms")
    print(f"spectral_counts {counts}")
    print(f"kernel wrapper launches {cuda.launch_counts()}")
    print(f"training steps by CUDA graph {trainer.graph_counts()} of {steps}")
    print(f"host launch calls: {launches} in the fit, {launches / steps:.1f} a training step; "
          f"device kernels and copies {len(events) / steps:.1f} a training step")
    print(f"device: busy {busy:.4f} s of {wall:.4f} s, idle share {1 - busy / wall:.4f}, "
          f"{len(events)} kernels and copies")
    print(f"cuSOLVER reductions by size (n: kernels, ms): "
          f"{ {n: (c, round(ms, 3)) for n, (c, ms) in sorted(reduction.items())} }")
    lines = [f"{'ms':>10} {'share':>7} {'count':>7}  name"]
    for name, (count, ms) in rows:
        lines.append(f"{ms:10.3f} {ms / (busy * 1e3):7.4f} {count:7d}  {name[:110]}")
    print("\n".join(lines[:20]))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
