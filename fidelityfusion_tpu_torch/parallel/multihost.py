"""Process-group initialization and the restart scaling measurement.

Port of `fidelityfusion_tpu/parallel/multihost.py`.  In the port a rank
is a process with its own device: `initialize_distributed` joins (or, for
one process, starts) the world, after which the `parallel/mesh.py`
helpers shard over every rank unchanged.  Nothing in the machine tells a
program of a cluster, so every rank is given the coordinator's address
(``host:port``), the world size and its rank.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from fidelityfusion_tpu_torch.parallel.collectives import choose_backend
from fidelityfusion_tpu_torch.parallel.mesh import ensure_world
from fidelityfusion_tpu_torch.utils.device import resolve_device


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device="cuda",
                           backend: Optional[str] = None) -> Dict:
    """Join a world of ``num_processes`` ranks at ``coordinator_address``
    (``host:port``, TCP) as rank ``process_id``; with one process (or none
    given), start a world of one if none exists.  The backend of a world
    of several follows `collectives.choose_backend` (NCCL needs a GPU per
    rank; pass ``backend="gloo"`` to share one); a world of one takes the
    default for ``device``.  Returns the JAX package's keys: this
    rank's index, the rank count, the devices this process drives (one)
    and the devices of the world."""
    device = resolve_device(device)
    if num_processes is not None and num_processes > 1:
        if not dist.is_initialized():
            dist.init_process_group(choose_backend(device, backend, num_processes),
                                    init_method=f"tcp://{coordinator_address}",
                                    world_size=num_processes, rank=process_id)
    else:
        ensure_world(device)
    return {"process_index": dist.get_rank(), "process_count": dist.get_world_size(),
            "local_devices": 1, "global_devices": dist.get_world_size()}


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def restart_scaling_efficiency(n: int = 256, steps: int = 100, restarts_per_device: int = 4,
                               device_counts=(1, None), reps: int = 3,
                               device="cuda") -> Dict[str, float]:
    """Weak-scaling efficiency of mesh-sharded restart training: for each
    rank count D (None = the world), D * ``restarts_per_device`` NLML-Adam
    restarts trained over a D-rank mesh (the first D ranks; the others
    wait), host seconds per run; efficiency = t(1) / t(D) (1.0: more
    restarts in the same time), the same on every rank (each times the
    members' runs between barriers).  Called by every rank of the world; the
    protocol is the JAX package's (SE CIGP, ``se_analytic_nll=False``)."""
    from torch.distributed.device_mesh import DeviceMesh

    from fidelityfusion_tpu_torch.models.cigp import CIGP
    from fidelityfusion_tpu_torch.ops.kernels import SquaredExponentialKernel
    from fidelityfusion_tpu_torch.parallel.mesh import sharded_fit_restarts
    from fidelityfusion_tpu_torch.utils.device import synced_time

    device = ensure_world(device)
    rng = np.random.default_rng(0)
    x = torch.tensor((rng.random((n, 1)) * 20).astype(np.float32), device=device)
    y = torch.sin(x)
    gp = CIGP(kernel=SquaredExponentialKernel(), se_analytic_nll=False)
    p0 = {"kernel": {"length_scale": torch.ones(1, device=device),
                     "signal_variance": torch.ones(1, device=device)},
          "log_beta": torch.ones(1, device=device)}
    times = {}
    for dc in device_counts:
        D = dc or dist.get_world_size()
        R = D * restarts_per_device
        batch = {"kernel": {k: torch.stack([v + 0.01 * i for i in range(R)])
                            for k, v in p0["kernel"].items()},
                 "log_beta": torch.stack([p0["log_beta"] + 0.01 * i for i in range(R)])}
        mesh = DeviceMesh(device.type, list(range(D)), mesh_dim_names=("restart",))
        member = mesh.get_coordinate() is not None

        def run():
            sharded_fit_restarts(gp.nll, batch, mesh, steps=steps, lr=1e-2, loss_args=(x, y))

        if member:
            run()  # warm-up
        dist.barrier()
        t0 = synced_time(device)
        if member:
            for _ in range(reps):
                run()
        dist.barrier()
        t1 = synced_time(device)
        times[D] = (t1 - t0) / reps
    base = times[min(times)]
    out = {}
    for D, t in times.items():
        out[f"time_s_D{D}"] = t
        out[f"weak_scaling_efficiency_D{D}"] = base / t
    return out


def free_ports(count: int = 1):
    """``count`` distinct TCP ports on localhost that were free a moment
    ago (bound to 0 together, then released)."""
    import socket

    socks = [socket.socket() for _ in range(count)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def launch_local_world(command, world_size: int, timeout: float, cwd=None,
                       port: Optional[int] = None):
    """Run ``command + ["--rank", r, "--world-size", W, "--port", p]`` for
    every rank r of a world of ``world_size`` processes on this host, all
    started together on the coordinator port ``port`` (a free one by
    default), and wait for them (each rank's output goes to a file, so no
    rank blocks on a full pipe).  Returns ``[(returncode, stdout,
    stderr)]`` by rank; ranks still running at ``timeout`` seconds are
    killed (returncode None)."""
    import subprocess
    import tempfile

    port = port or free_ports()[0]
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        for r in range(world_size):
            out = open(f"{tmp}/{r}.out", "w+")
            err = open(f"{tmp}/{r}.err", "w+")
            procs.append((subprocess.Popen(
                list(command) + ["--rank", str(r), "--world-size", str(world_size),
                                 "--port", str(port)],
                stdout=out, stderr=err, text=True, cwd=cwd), out, err))
        deadline = time.monotonic() + timeout
        results = []
        try:
            for p, out, err in procs:
                try:
                    p.wait(timeout=max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    pass
        finally:
            for p, out, err in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                    code = None
                else:
                    code = p.returncode
                out.seek(0)
                err.seek(0)
                results.append((code, out.read(), err.read()))
                out.close()
                err.close()
    return results
