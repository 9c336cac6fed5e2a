"""The run of one cell: set-up, the measured window, the traced segment,
the comparison with the reference, and the result line.

A cell is found by name: `workloads/<cell>.json` gives its configuration,
traffic mix, chips and the limits of its checks; the traffic file names the
driver module that runs it.  Which metrics a run prints comes from
`BENCHMARK.json` when it names the cell, else from the driver.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "fidelityfusion_tpu")


def process_start_time(fallback: float) -> float:
    """The process's start, in `time.time()` seconds, from /proc (Linux);
    ``fallback`` where that cannot be read."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        btime = next(int(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                     if line.startswith("btime"))
        start = btime + ticks / os.sysconf("SC_CLK_TCK")
        return start if start <= fallback else fallback
    except (OSError, ValueError, IndexError, StopIteration):
        return fallback


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of `FORBIDDEN`, compared
    whole (``fidelityfusion_tpu_torch`` is the port and allowed)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths, so
    only a checkout's first run builds.  The port's nvcc libraries go to
    ``build/torch_kernels`` by themselves (`ops/cuda.py`)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(kind: str, name: str, suffix: str = ".json") -> Path:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = HERE / kind / f"{name}{suffix}"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    return path


def workload(name: str) -> dict:
    return {"name": name, **_load(_named("workloads", name))}


def config(name: str) -> dict:
    return {"name": name, **_load(_named("configs", name))}


def traffic(name: str) -> dict:
    return {"name": name, **_load(_named("traffic", name))}


def driver(name: str):
    if not re.match(r"^[A-Za-z_][A-Za-z0-9_]*$", name):
        raise ValueError(f"bad driver name {name!r}")
    return importlib.import_module(f"portbench.drivers.{name}")


def metric_reader(name: str):
    """The reader module `metrics/<name>.py` (names may hold dots)."""
    path = _named("metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest() -> Optional[dict]:
    path = ROOT / "BENCHMARK.json"
    return _load(path) if path.exists() else None


def _applies(entry: dict, cell: str, e2e: List[str]) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves", None) in e2e if "moves" in entry else True


def cell_metrics(bench: Optional[dict], cell: str, driver_e2e) -> tuple:
    """(end-to-end names, per-layer names) this cell reports: those
    `BENCHMARK.json` gives it, or, for a cell it does not name, set-up and
    the driver's own plus every per-layer metric moving one of them."""
    named = bench is not None and any(w["name"] == cell for w in bench["workloads"])
    if named:
        e2e = [m["name"] for m in bench["end_to_end"] if _applies(m, cell, [])]
    else:
        e2e = ["setup_s", *driver_e2e]
    per_layer = [m["name"] for m in (bench or {}).get("per_layer", [])
                 if _applies(m, cell, e2e)]
    return e2e, per_layer


@dataclasses.dataclass
class Run:
    """What a driver and a metric reader see of one run."""

    cell: str
    seed: int
    seconds: float
    trace: bool
    workload: dict
    config: dict
    traffic: dict
    device: Any = None
    spans: List[tuple] = dataclasses.field(default_factory=list)  # (name, t0_ns, t1_ns)
    records: List[dict] = dataclasses.field(default_factory=list)  # the window's units
    window_s: float = 0.0
    traced: Any = None  # trace.TraceSummary of the traced segment

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def sync(self) -> None:
        import torch

        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def device_info(torch, chips: int) -> dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", "0"], capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        info["power_limit_w"] = None
    return info


def window(run: Run, drv, state) -> None:
    """Units of work back to back from the window's start until
    ``run.seconds`` have passed; the unit in progress then completes and
    counts.  Sets ``run.records`` and ``run.window_s``."""
    t0 = time.time()
    i = 0
    while True:
        run.records.append(drv.unit(run, state, i))
        i += 1
        if time.time() - t0 >= run.seconds:
            break
    run.window_s = time.time() - t0


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def check_line(checks: List[tuple]) -> Dict[str, dict]:
    return {name: {"value": value, "limit": limit} for name, value, limit in checks}


def compared(readings: List[tuple], limits: dict) -> tuple:
    """The readings a cell compares (those its workload file gives a
    limit) as ``(name, value, limit)``, and the others, printed for
    information only."""
    checks = [(n, v, limits[n]) for n, v in readings if n in limits]
    info = [(n, v) for n, v in readings if n not in limits]
    return checks, info


def correct_of(checks: List[tuple]) -> bool:
    return bool(checks) and all(_finite(v) and v <= lim for _, v, lim in checks)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, t_start: float) -> int:
    """The command's run: on a CUDA device or not at all."""
    set_cache_dirs()
    import torch

    wl = workload(cell)
    chips = int(wl.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell {cell} needs {chips} CUDA device(s); "
              f"cuda available: {torch.cuda.is_available()}, "
              f"devices: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(min(4, torch.get_num_threads()))
    result = execute(cell, seed, seconds, trace, t_start, torch.device("cuda", 0))
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 4
    del result["info"]
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def execute(cell: str, seed: int, seconds: float, trace: bool, t_start: float, device,
            traffic_overrides: Optional[dict] = None, config_overrides: Optional[dict] = None
            ) -> dict:
    """Set-up, window, traced segment, metrics and checks of one run on
    ``device``; returns the result object.  ``traffic_overrides`` serve
    the CPU tests, which run a cell at a tiny size; ``config_overrides``
    the controls, which run the program in another precision."""
    import torch

    wl = workload(cell)
    cfg, tr = config(wl["config"]), traffic(wl["traffic"])
    tr.update(traffic_overrides or {})
    cfg.update(config_overrides or {})
    drv = driver(tr["driver"])
    on_card = device.type == "cuda"
    run = Run(cell, seed, seconds, trace, wl, cfg, tr, device=device)
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(cfg.get("tf32", False))
    bench = manifest()
    e2e_names, layer_names = cell_metrics(bench, cell, drv.E2E)

    phases = [("start", time.time())]
    importlib.import_module("fidelityfusion_tpu_torch.models.ar")
    phases.append(("the port's import", time.time()))
    torch.zeros(1, device=device)
    run.sync()
    phases.append(("the device's context", time.time()))
    state = drv.setup(run)
    run.sync()
    phases.append(("the driver's set-up (inputs, model, warm-up)", time.time()))
    setup_s = time.time() - t_start
    parts = [f"process start to here {phases[0][1] - t_start:.3f} s"] + [
        f"{name} {t - t0:.3f} s" for (_, t0), (name, t) in zip(phases, phases[1:])]
    print(f"portbench: set-up {setup_s:.3f} s: " + ", ".join(parts), file=sys.stderr)
    window(run, drv, state)
    run.sync()
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    if trace:
        from portbench import trace as tracing

        run.traced = tracing.profile_segment(run, lambda: drv.traced(run, state))

    e2e = {"setup_s": setup_s, **drv.end_to_end(run, state)}
    units = {m["name"]: m["unit"] for m in (bench or {}).get("end_to_end", [])
             + (bench or {}).get("per_layer", [])}
    metrics = {}
    if not trace:
        for name in e2e_names:
            if name not in e2e:
                raise KeyError(f"the driver {tr['driver']} gives no {name}")
            metrics[name] = {"value": e2e[name], "unit": units.get(name, drv.UNITS.get(name))}
    else:
        for name in layer_names:
            value = metric_reader(name).read(run)
            if value is not None:
                metrics[name] = {"value": value, "unit": units.get(name)}
    attempted, failed = drv.attempted_failed(run)

    checks, info = compared(drv.check(run, state), wl["limits"])
    del state
    for name, value in info:
        print(f"info {name} = {value!r} (not compared)", file=sys.stderr)
    dev_info = device_info(torch, int(wl.get("chips", 1))) if on_card else {"platform": "cpu"}
    result = {"correct": correct_of(checks), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": {**dev_info, "memory_peak_bytes": memory_peak}}
    if trace and run.traced is not None:
        result["device"]["busy_s"] = run.traced.busy_s
        result["device"]["window_s"] = run.traced.window_s
        result["breakdown"] = run.traced.breakdown()
    result["info"] = {name: value for name, value in info}
    result["checks"] = check_line(checks)
    return result
