#!/usr/bin/env python3
"""Device busy share and kernel time by name on the port's AR main path.

    python3 scripts/profile_torch_ar.py [--iters 30] [--out FILE]

Runs the configuration of `chip_smoke.py`'s main path on one GPU through
the PyTorch port (3-fidelity toy sin, nested (1024, 512, 256)-row stages,
SE CIGPs, 4 restarts, lr 5e-2): one warm-up `train_AR`, then one
`train_AR` of ``--iters`` Adam steps per stage under `torch.profiler`.
Prints the card's name and power limit, the window's wall seconds per
stage (host clock, synchronized), the kernel wrappers' launch counts,
the device time of its kernels and copies (union of their intervals),
the device idle share 1 - busy / wall, device kernels per Adam step, and
the kernels by device time; ``--out`` also receives the full table.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_events(prof, torch):
    """(name, start_us, end_us) of every kernel and copy the trace holds."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=30, help="Adam steps per stage")
    parser.add_argument("--out", type=Path, default=None, help="file for the full table")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_ar: torch.cuda.is_available() is False; needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from chip_smoke import SIZES, StageClock, main_path_setup, smi_line
    from fidelityfusion_tpu_torch.ops import cuda
    from fidelityfusion_tpu_torch.models.ar import train_AR

    device = torch.device("cuda")
    model, dm, _, _ = main_path_setup(device)
    train_AR(model, dm, max_iter=5, lr_init=5e-2, n_restarts=4)  # build + warm-up
    model, dm, _, _ = main_path_setup(device)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    cuda.reset_launch_counts()
    with torch.profiler.profile(activities=acts) as prof:
        clock = StageClock(torch)
        t0 = time.perf_counter()
        train_AR(model, dm, max_iter=args.iters, lr_init=5e-2, n_restarts=4, debugger=clock)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(prof, torch)
    if not events:
        print("profile_torch_ar: the trace holds no device events", file=sys.stderr)
        return 1
    busy = busy_us([(s, e) for _, s, e in events]) * 1e-6
    span = (max(e for _, _, e in events) - min(s for _, s, _ in events)) * 1e-6
    steps = 3 * args.iters
    by_name = defaultdict(lambda: [0, 0.0])
    for name, s, e in events:
        by_name[name][0] += 1
        by_name[name][1] += (e - s) * 1e-3
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])

    print(f"{smi_line()}  torch {torch.__version__}")
    for i, sec in enumerate(clock.seconds):
        print(f"stage {i}: rows {SIZES[i]}  wall {sec:.4f} s  {sec / args.iters * 1e3:.3f} ms/step")
    print(f"kernel wrapper launches {cuda.launch_counts()}")
    print(f"window: wall {wall:.4f} s  device busy {busy:.4f} s  device span {span:.4f} s  "
          f"idle share {1 - busy / wall:.4f}  device events {len(events)}  "
          f"per Adam step {len(events) / steps:.1f}")
    lines = [f"{'ms':>10} {'share':>7} {'count':>7}  name"]
    for name, (count, ms) in rows:
        lines.append(f"{ms:10.3f} {ms / (busy * 1e3):7.4f} {count:7d}  {name[:110]}")
    print("\n".join(lines[:16]))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
