"""The controls: each cell computed one precision below the one its
configuration states, judged by the cell's own comparison.  A control has
to come out not correct: that is what shows the comparison can fail.  The
benchmark's runs do not run it.

Where the program has the lower precision as a path of its own, the
program with that path on is the control: the AR configuration states
float32 with TF32 off, and every float32 product of the port through
cuBLAS takes TF32 once ``torch.backends.cuda.matmul.allow_tf32`` is on,
so those cells run whole (a short window) with it on.  Where it has none,
the driver's ``control`` puts the reference in the program's place.

    python3 -m portbench.control --workload <cell> --seeds 1 2 3

prints one JSON line per seed with the control's readings beside the
cell's limits.  Needs a CUDA device (TF32 exists only there).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def fault_readings(cell: str, seed: int, device, fault: str, seconds: float) -> dict:
    """A run of ``cell`` with ``fault`` planted under its timed path."""
    from portbench import faults, harness

    with faults.FAULTS[fault]():
        out = harness.execute(cell, seed, seconds, False, time.time(), device)
    return {"seed": seed, "fault": fault, "correct": out["correct"],
            "readings": {**out["checks"], **{k: {"value": v} for k, v in out["info"].items()}}}


def readings(cell: str, seed: int, device) -> dict:
    """The control's numbers of ``cell`` at ``seed``: ``{name: (value,
    limit)}`` and whether they pass."""
    from portbench import harness

    wl = harness.workload(cell)
    cfg, tr = harness.config(wl["config"]), harness.traffic(wl["traffic"])
    drv = harness.driver(tr["driver"])
    if hasattr(drv, "CONTROL_CONFIG"):
        out = harness.execute(cell, seed, tr["control_seconds"], False, time.time(), device,
                              config_overrides=drv.CONTROL_CONFIG)
        checks = [(n, c["value"], c["limit"]) for n, c in out["checks"].items()]
        checks += [(n, v, None) for n, v in out["info"].items()]
    else:
        run = harness.Run(cell, seed, 0.0, False, wl, cfg, tr, device=device)
        got = drv.control(run, drv.control_state(run))
        checks = [(n, v, wl["limits"].get(n)) for n, v in got]
    return {"seed": seed,
            "correct": harness.correct_of([c for c in checks if c[2] is not None]),
            "readings": {n: {"value": v, "limit": lim} for n, v, lim in checks}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default=None,
                    help="read this fault (portbench/faults.py) instead of the control")
    ap.add_argument("--seconds", type=float, default=1.0, help="the fault runs' window")
    args = ap.parse_args(argv)
    from portbench import harness

    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("portbench.control needs a CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        t0 = time.time()
        dev = torch.device("cuda", 0)
        out = (fault_readings(args.workload, seed, dev, args.fault, args.seconds) if args.fault
               else readings(args.workload, seed, dev))
        out["seconds"] = time.time() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
