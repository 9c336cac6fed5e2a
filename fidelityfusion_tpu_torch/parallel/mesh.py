"""Device meshes and the embarrassingly parallel axes, over ranks.

Port of `fidelityfusion_tpu/parallel/mesh.py`.  A mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the world's ranks, one
rank a process with its own tensors; every function here is called by
every rank of the mesh with the same (replicated) arguments, and each
rank works on its own block of the sharded axis:

  * hyperparameter restarts (`sharded_fit_restarts`): each rank trains
    its block of the restart batch; the winner is a cross-rank argmin;
  * acquisition candidates (`sharded_acq_argmax`): each rank scores its
    rows, the argmax is taken over the gathered scores;
  * test rows of a posterior mean (`sharded_posterior_mean`): each rank
    builds its block of the cross-Gram, the rows are gathered.

Where no process group exists, `make_mesh` first starts a world of one
process (an in-memory `HashStore`), the way the JAX package runs on one
process: a single-process caller needs no launcher.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from fidelityfusion_tpu_torch.parallel.collectives import (
    all_gather_rows, all_reduce_sum, choose_backend)
from fidelityfusion_tpu_torch.utils.device import resolve_device
from fidelityfusion_tpu_torch.utils.tree import tree_leaves, tree_map


def ensure_world(device="cuda") -> torch.device:
    """Start a single-process world (rank 0 of 1) when none exists, with
    `choose_backend`'s backend for ``device``; returns the device.  Raises
    for ``device="cuda"`` without CUDA."""
    device = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group(choose_backend(device, None, 1), store=dist.HashStore(),
                                rank=0, world_size=1)
    return device


def grid_mesh(shape, names, device="cuda") -> DeviceMesh:
    """A `DeviceMesh` of ``shape`` (its product the world size) with dims
    ``names`` over the world's ranks, on ``device``'s type."""
    device = ensure_world(device)
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {tuple(shape)} does not cover the world of {world} ranks")
    return init_device_mesh(device.type, tuple(shape), mesh_dim_names=tuple(names))


def make_mesh(axis_name: str = "restart", device="cuda") -> DeviceMesh:
    """1-D mesh over every rank of the world (a rank cannot sit out of
    the program)."""
    device = ensure_world(device)
    return grid_mesh((dist.get_world_size(),), (axis_name,), device)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    return int(mesh.get_local_rank(axis))


def shard_leading_axis(tree, mesh: DeviceMesh, axis_name: str = "restart"):
    """This rank's contiguous block of the leading axis of every leaf
    (the leading size must divide by the axis size)."""
    P, i = axis_size(mesh, axis_name), axis_index(mesh, axis_name)

    def block(leaf):
        if leaf.shape[0] % P:
            raise ValueError(f"leading axis {leaf.shape[0]} does not divide by the "
                             f"{axis_name!r} axis size {P}")
        b = leaf.shape[0] // P
        return leaf[i * b:(i + 1) * b]

    return tree_map(block, tree)


def sharded_fit_restarts(loss_fn: Callable, params_batch, mesh: DeviceMesh, steps: int = 100,
                         lr: float = 1e-2, axis_name: str = "restart",
                         loss_args: Optional[tuple] = None, aux0=None):
    """`train/fit.py:fit_restarts` with the restart axis sharded over the
    mesh: each rank trains its block of restarts (and of ``aux0``), the
    loss histories are gathered, and the winner is the lowest last finite
    loss whose unbatched re-evaluation (on the rank that trained it) is
    finite, walked best-first as `fit_restarts` does; its parameters are
    broadcast from that rank.  Returns ``(best_params, FitResult(params,
    losses))`` over the whole batch, the same on every rank."""
    from fidelityfusion_tpu_torch.train.fit import (
        FitResult, _unbatched_loss, fit_restarts, restart_scores)

    group = mesh.get_group(axis_name)
    me = axis_index(mesh, axis_name)
    local = shard_leading_axis(params_batch, mesh, axis_name)
    aux_local = None if aux0 is None else shard_leading_axis(aux0, mesh, axis_name)
    _, res = fit_restarts(loss_fn, local, steps=steps, lr=lr, loss_args=loss_args,
                          aux0=aux_local)
    rows = tree_leaves(res.params)[0].shape[0]
    losses = all_gather_rows(res.losses, group)
    params_all = tree_map(lambda a: all_gather_rows(a, group), res.params)
    evaluate = _unbatched_loss(loss_fn, aux_local)
    score = restart_scores(losses)
    dev = losses.device
    winner = int(np.argmin(score))
    with torch.no_grad():
        for idx in np.argsort(score):
            if not np.isfinite(score[idx]):
                break
            owner, j = divmod(int(idx), rows)
            ok = torch.zeros((), device=dev)
            if me == owner:
                cand = tree_map(lambda a: a[j], res.params)
                ok = torch.as_tensor(float(np.isfinite(float(evaluate(cand, *(loss_args or ()))))),
                                     device=dev)
            if float(all_reduce_sum(ok, group)) > 0:
                winner = int(idx)
                break
    owner, j = divmod(winner, rows)
    best = tree_map(lambda a: all_reduce_sum(a[j] if me == owner else torch.zeros_like(a[j]),
                                             group), res.params)
    return best, FitResult(params_all, losses)


def sharded_acq_argmax(acq_fn: Callable[[torch.Tensor], torch.Tensor], candidates: torch.Tensor,
                       mesh: DeviceMesh, axis_name: str = "restart") -> Tuple[torch.Tensor,
                                                                              torch.Tensor]:
    """Score a candidate batch with its rows sharded over the mesh:
    ``(best_x, best_value)``, the same on every rank."""
    local = shard_leading_axis(candidates, mesh, axis_name)
    with torch.no_grad():
        vals = all_gather_rows(acq_fn(local).reshape(-1), mesh.get_group(axis_name))
    best = int(torch.argmax(vals))
    return candidates[best], vals[best]


def sharded_posterior_mean(kernel_apply: Callable, kernel_params, x_train: torch.Tensor,
                           alpha: torch.Tensor, x_test: torch.Tensor, mesh: DeviceMesh,
                           axis_name: str = "restart") -> torch.Tensor:
    """Row-sharded posterior mean ``K(x_test, x_train) @ alpha``: each rank
    builds its block of test rows' cross-Gram (no collective on the way),
    and the rows are gathered."""
    xt = shard_leading_axis(x_test, mesh, axis_name)
    with torch.no_grad():
        return all_gather_rows(kernel_apply(kernel_params, xt, x_train) @ alpha,
                               mesh.get_group(axis_name))
