#!/usr/bin/env python3
"""Runs `chip_smoke.py`'s kernel phase, or its training steps, on the port in a given tree, on one GPU.

    python3 scripts/time_torch_kernels.py [--root DIR] [--steps | --kron]

Imports `fidelityfusion_tpu_torch` from DIR (default: this checkout), and
the driver code from this checkout's `chip_smoke.py`, so the same code runs
on a parent commit unpacked beside the change: run parent, change, change,
parent in one call to compare the two on one card.  Prints the card's name
and power limit, then:

- by default, chip_smoke's phase 2 (`kernel_checks`): every kernel against
  its plain version, timed beside its bound, plain version and library
  call (K1 and K3b by device time from CUDA graphs), K1 at d = 1, 2 and 4,
  K2 at n = 1024/1792/2048, K3b at R=4, n=256/512/1024 and R=1,
  n=1792/2048; the last line is a JSON object of the kernels' ms;
- with ``--steps``, whole training steps, with no CUDA graph and no
  profiler in the process: the unbatched n = 2048 SE and ARD fits once to
  warm up, chip_smoke's main path (`train_AR`, 200 Adam steps a stage),
  and the unbatched fits again; the last line is a JSON object of ms per
  step;
- with ``--kron``, chip_smoke's hogp1024 fit (130 tracked steps) on the
  data of seeds 0-3 and GAR (200 Adam steps a stage, 4 restarts), warmed
  up by one hogp1024 fit first: ms per step, and each fit's NLML through
  the kernels against the plain float64 one; the last line is a JSON
  object of both.

Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def kernel_times(torch, smoke, device, root) -> int:
    report = {}
    smoke.kernel_checks(torch, device, report)
    ms = {key: {row["shape"]: row["ms"] for row in report[key].get("shapes", [report[key]])}
          for key in report}
    for key in ("d2", "d4"):
        row = report["gram"][key]
        ms["gram"][row["shape"]] = row["ms"]
    ms["gram"][report["gram"]["d4"]["cross_shape"]] = report["gram"]["d4"]["cross_ms"]
    print(json.dumps({"root": str(root), "ms": ms, "failures": len(smoke.FAILURES)}), flush=True)
    return 1 if smoke.FAILURES else 0


def step_times(torch, smoke, device, root) -> int:
    smoke.unbatched_paths(torch, device)  # warm-up: the kernels, cuBLAS, the allocator
    report = {}
    smoke.main_path(torch, device, 200, report)
    unbatched = smoke.unbatched_paths(torch, device)
    print(json.dumps({
        "root": str(root),
        "stage_ms_per_step": [s / 200 * 1e3 for s in report["stage_seconds"]],
        "unbatched_ms_per_step": unbatched, "failures": len(smoke.FAILURES)}), flush=True)
    return 1 if smoke.FAILURES else 0


def kron_times(torch, smoke, device, root) -> int:
    report = {"launches_by_path": {}, "kron": {}}
    smoke.hogp1024_path(torch, device, report)  # warm-up
    hogp = []
    for seed in range(4):
        smoke.hogp1024_path(torch, device, report, seed=seed)
        h = report["kron"]["HOGP"]
        hogp.append(dict(seed=seed, ms_per_step=h["ms_per_step"],
                         tracked_step_ms=h["tracked_step_ms"], nll=h["final_nll"],
                         rel_err_vs_f64=abs(h["final_nll"] - h["plain64_nll"])
                         / max(abs(h["plain64_nll"]), 1.0)))
    smoke.gar_path(torch, device, 200, report)
    print(json.dumps({
        "root": str(root), "hogp1024": hogp,
        "gar_stage_ms_per_step": [st["ms_per_step"] for st in report["kron"]["GAR"]["stages"]],
        "failures": len(smoke.FAILURES)}), flush=True)
    return 1 if smoke.FAILURES else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=HERE,
                        help="checkout whose fidelityfusion_tpu_torch is run")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--steps", action="store_true",
                      help="time training steps instead of the kernels")
    mode.add_argument("--kron", action="store_true",
                      help="time the Kronecker path's fits (hogp1024, GAR) instead")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_torch_kernels: needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda")

    from fidelityfusion_tpu_torch.ops import chol, cuda, gram

    cuda.build([gram._LIB, chol._CHOL, chol._TRI])
    print(f"root {args.root}  {smoke.smi_line()}", flush=True)
    run = step_times if args.steps else kron_times if args.kron else kernel_times
    return run(torch, smoke, device, args.root)


if __name__ == "__main__":
    sys.exit(main())
