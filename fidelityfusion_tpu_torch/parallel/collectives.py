"""The collectives of the sharding layer, over `torch.distributed`.

The JAX package's sharded programs use ``lax.psum``, ``lax.all_gather`` and
``lax.axis_index`` inside ``shard_map``; here every rank is a process and
these are their counterparts on a process group:

    all_reduce_sum(t, group)    # psum: a new tensor, ``t`` is not touched
    all_gather_rows(t, group)   # all_gather along ``dim`` (0), tiled
    rank(group), size(group)    # axis_index, the axis size

The backend rule (`choose_backend`): NCCL where every rank has a GPU of its
own, gloo on CPU tensors, and gloo on CUDA tensors only where the caller
names it (several ranks sharing one card, which NCCL refuses with
"Duplicate GPU detected").  gloo cannot all-gather CUDA tensors, so on a
gloo group every collective of a CUDA tensor is staged through a pinned
host buffer: a copy to the host, the collective there, a copy back.  Nothing
here switches backend on its own.

Three autograd Functions carry the gradient contract of ``shard_map``:

  * `psum`: a differentiable all-reduce whose backward all-reduces the
    cotangents (the transpose of a psum is a psum), as for the mean Gram
    diagonal every rank's noise floor reads;
  * `sum_partials`: the total of per-rank partial losses, whose backward
    hands each rank's partial the (replicated) cotangent unchanged - the
    partials' closed-form backward passes already give the total's
    gradient with respect to the rank's own rows;
  * `replicate_tree`: replicated inputs (the parameters), identity
    forward, whose backward sums the ranks' partial cotangents with one
    all-reduce for the whole tree.

Combining `psum` at the loss with a second reduction of the parameter
gradients would count each gradient ``size`` times; `sum_partials` is
what keeps it once.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from fidelityfusion_tpu_torch.utils.tree import tree_leaves, tree_unflatten


def choose_backend(device, backend: Optional[str], world_size: int) -> str:
    """The process-group backend for ranks that hold their tensors on
    ``device``: ``backend`` when given, else NCCL on CUDA and gloo on the
    CPU.  NCCL with more ranks than visible GPUs raises (it would refuse
    two ranks on one card); pass ``backend="gloo"`` for that layout."""
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the NCCL backend needs CUDA tensors; use gloo on the CPU")
        n_gpu = torch.cuda.device_count()
        if world_size > n_gpu:
            raise RuntimeError(
                f"NCCL needs one GPU per rank: {world_size} ranks, {n_gpu} GPU(s) visible "
                "(NCCL refuses two ranks on one GPU, 'Duplicate GPU detected'); pass "
                "backend='gloo' to run several ranks on one card")
    return backend


def rank(group=None) -> int:
    """This process's index in ``group`` (``lax.axis_index``)."""
    return dist.get_rank(group)


def size(group=None) -> int:
    """The number of ranks in ``group`` (the axis size)."""
    return dist.get_world_size(group)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a collective of ``t`` on ``group`` goes through the host:
    CUDA tensors on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise sum of ``t`` over the ranks of ``group`` (a new
    tensor on ``t``'s device)."""
    if _staged(t, group):
        h = _to_host(t)
        dist.all_reduce(h, group=group)
        return h.to(t.device)
    out = t.detach().clone().contiguous()
    dist.all_reduce(out, group=group)
    return out


def all_gather_rows(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order (the
    tiled ``lax.all_gather``); every rank's ``t`` has the same shape."""
    src = t.detach().contiguous()
    if _staged(src, group):
        src = _to_host(src)
    parts = [torch.empty_like(src) for _ in range(size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _GatherRows(torch.autograd.Function):
    """all_gather of per-rank rows whose cotangent is replicated: each rank
    takes back its own block of it."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.rows, ctx.rank = t.shape[0], rank(group)
        return all_gather_rows(t, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def psum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable `all_reduce_sum`: its backward all-reduces too."""
    return _Psum.apply(t, group)


def sum_partials(t: torch.Tensor, group=None) -> torch.Tensor:
    """The total of the ranks' partials ``t``; backward passes the
    cotangent to the local partial as it is (see the module docstring)."""
    return _SumPartials.apply(t, group)


def gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable `all_gather_rows` (dim 0) of a result whose
    cotangent is the same on every rank."""
    return _GatherRows.apply(t, group)


def replicate_tree(tree, group=None):
    """Mark every leaf of a parameter tree as a replicated input (identity
    forward, cotangents summed over ``group`` in backward) with one
    all-reduce: the leaves are flattened into one vector, marked, and cut
    back to their shapes."""
    leaves = tree_leaves(tree)
    if not any(leaf.requires_grad for leaf in leaves):
        return tree
    flat = _Replicated.apply(torch.cat([leaf.reshape(-1) for leaf in leaves]), group)
    out, at = [], 0
    for leaf in leaves:
        out.append(flat[at:at + leaf.numel()].reshape(leaf.shape).to(leaf.dtype))
        at += leaf.numel()
    return tree_unflatten(tree, out)
