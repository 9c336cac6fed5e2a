"""n-axis sharded NLML: distributed Gram + blocked Cholesky over the ranks.

Port of `fidelityfusion_tpu/parallel/nsharded.py`.  The training-set axis
itself is sharded: every rank owns a contiguous row block (b = n/P rows)
of the Gram and of its Cholesky factor, built from ``(x_local, x_full)``
so that no rank holds the n x n Gram, and the factorization is the
right-looking blocked Cholesky laid out across ranks.  Per panel j:

  * the b x b diagonal block is replicated by a masked all-reduce and
    factored on every rank: K2 (one matrix) or K3a (a rank's restart
    group) for ``(L_jj, W_d)``, then K3b for ``W_jj = inv(L_jj)``
    (`ops/blocked.py:chol_inv_padded`, which identity-pads a b that is
    not a multiple of the kernels' 64-row panel);
  * the panel solve is a local product with ``W_jj`` and the trailing
    Schur update a local product with the all-gathered panel column
    (`torch.matmul`: plain products, as the JAX package leaves them to
    XLA; TF32 stays off).

The NLML's terms reduce over ranks, and its closed-form backward
(`ops/linalg.py:_MvnNll`'s dSigma = 0.5 (d K^-1 - alpha alpha^T)) builds its
row block of K^-1 from a distributed triangular inverse and an
all-reduced W^T W contraction, so backward memory is O(n^2 / P) too.
Substitutions multiply by ``W_jj`` where the JAX package solves with
``L_jj``, as the port's posteriors do.

The SPMD program maps to ranks so (`parallel/collectives.py`):

  * every rank calls these functions with the same replicated ``x``, ``y``
    and parameters (tensors or arrays; the data take the parameters'
    device and dtype) and takes its own rows;
  * `mvn_nll_rowsharded` returns the rank's PARTIAL NLML, whose backward
    is the gradient of the TOTAL with respect to the rank's rows; the
    partials are summed by `sum_partials`, which hands each the same
    cotangent, as ``shard_map``'s out_specs do in JAX;
  * the mean Gram diagonal of the noise floor is a differentiable
    all-reduce (`psum`), and the parameters enter through
    `replicate_tree`, whose backward sums the ranks' partial gradients,
    so ``torch.autograd.grad`` of the returned total gives the full
    gradient, the same on every rank.

Rows pad to a multiple of P with identity rows (the padded NLML minus
their 2 pi constant is exactly the unpadded one).  Meshes come from
`make_n_mesh` (1-D, dim "n") and `make_rn_mesh` (2-D ``(n_r, n_n)``, dims
"r" and "n"); the factorization's collectives run on the "n" group.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from fidelityfusion_tpu_torch.parallel.collectives import (
    all_gather_rows, all_reduce_sum, gather_rows, psum, rank, replicate_tree, sum_partials)
from fidelityfusion_tpu_torch.parallel.mesh import (
    axis_size, ensure_world, grid_mesh, make_mesh, shard_leading_axis)
from fidelityfusion_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

LOG2PI = math.log(2.0 * math.pi)


def _factor_blocks(D):
    """``(L_jj, W_jj)`` of (B, b, b) SPD blocks: K2 + K3b for one matrix,
    K3a + K3b for a batch."""
    from fidelityfusion_tpu_torch.ops.blocked import chol_inv_padded

    if D.shape[0] == 1:
        L, W = chol_inv_padded(D[0])
        return L[None], W[None]
    return chol_inv_padded(D)


def _zeros_if(cond, t):
    return t if cond else torch.zeros_like(t)


def _dist_chol(A_local, group, nblk, b):
    """Distributed right-looking blocked Cholesky of the (B, b, n) row
    block ``A_local`` of SPD A.  Returns this rank's (B, b, n) block of the
    lower factor and the replicated per-panel ``L_jj`` and ``W_jj =
    inv(L_jj)`` (lists of (B, b, b))."""
    me = rank(group)
    A = A_local.clone()
    L_local = torch.zeros_like(A)
    Ljj, Wjj = [], []
    for j in range(nblk):
        cols = slice(j * b, (j + 1) * b)
        # panel j's diagonal block lives on rank j: a masked all-reduce replicates it
        Lj, Wj = _factor_blocks(all_reduce_sum(_zeros_if(me == j, A[..., cols]), group))
        if me == j:
            panel = Lj
        elif me > j:  # panel solve: L_ij = A_ij inv(L_jj)^T
            panel = A[..., cols] @ Wj.transpose(-1, -2)
        else:
            panel = torch.zeros_like(Lj)
        L_local[..., cols] = panel
        # the trailing Schur update needs the whole panel column
        Lcol = all_gather_rows(panel, group, dim=-2)  # (B, n, b)
        if me > j:
            A[..., (j + 1) * b:] -= panel @ Lcol[..., (j + 1) * b:, :].transpose(-1, -2)
        Ljj.append(Lj)
        Wjj.append(Wj)
    return L_local, Ljj, Wjj


def _dist_forward_solve(L_local, Wjj, y_local, group, nblk, b):
    """z = L^-1 y by blocked forward substitution: every block of z,
    (B, b, d) each, replicated (they are small)."""
    me = rank(group)
    acc = y_local.clone()
    zs = []
    for j in range(nblk):
        zj = Wjj[j] @ all_reduce_sum(_zeros_if(me == j, acc), group)
        zs.append(zj)
        if me > j:
            acc -= L_local[..., j * b:(j + 1) * b] @ zj
    return zs


def _dist_backward_solve(L_local, Wjj, zs, group, nblk, b):
    """alpha = L^-T z by blocked backward substitution (reverse order):
    every block, replicated."""
    me = rank(group)
    alphas = [None] * nblk
    alpha_my = torch.zeros_like(zs[0])
    for j in reversed(range(nblk)):
        own = L_local[..., j * b:(j + 1) * b].transpose(-1, -2) @ alpha_my
        contrib = all_reduce_sum(_zeros_if(me > j, own), group)
        alphas[j] = Wjj[j].transpose(-1, -2) @ (zs[j] - contrib)
        if me == j:
            alpha_my = alphas[j]
    return alphas


def _dist_tri_inv(L_local, Wjj, group, nblk, b):
    """This rank's row block of W = inv(L): rank k's block is finished at
    step k from the broadcast rows of the blocks before it (O(n^2 / P)
    memory a rank)."""
    me = rank(group)
    S = torch.zeros_like(L_local)  # sum_{j<k} L_kj W_j, columns < k b
    W_local = torch.zeros_like(L_local)
    for k in range(nblk):
        if me == k:  # S's columns from k b on are zero: W_kj = -W_kk S_j for j < k
            W_local[..., :k * b] = -(Wjj[k] @ S[..., :k * b])
            W_local[..., k * b:(k + 1) * b] = Wjj[k]
        Wk = all_reduce_sum(_zeros_if(me == k, W_local), group)
        if me > k:
            S += L_local[..., k * b:(k + 1) * b] @ Wk
    return W_local


def _dist_kinv_rows(W_local, group, nblk, b):
    """This rank's row block of K^-1 = W^T W, one all-reduced (B, b, n)
    target block at a time."""
    me = rank(group)
    out = None
    for i in range(nblk):
        # W_local's column block i is zero for i > this rank's block
        part = (W_local[..., i * b:(i + 1) * b].transpose(-1, -2) @ W_local if i <= me
                else torch.zeros_like(W_local))
        Ci = all_reduce_sum(part, group)
        if me == i:
            out = Ci
    return out


class _MvnNllRowsharded(torch.autograd.Function):
    """Partial NLML of the rank's rows (B,) with the closed-form backward
    of the total (the JAX package's `_nll_rowsharded_bwd`)."""

    @staticmethod
    def forward(ctx, Sigma_local, y_local, group, nblk, b):
        me = rank(group)
        d = y_local.shape[-1]
        L_local, Ljj, Wjj = _dist_chol(Sigma_local, group, nblk, b)
        zs = _dist_forward_solve(L_local, Wjj, y_local, group, nblk, b)
        val = (0.5 * (zs[me] * zs[me]).sum((-2, -1))
               + d * torch.log(Ljj[me].diagonal(dim1=-2, dim2=-1)).sum(-1)
               + 0.5 * b * d * LOG2PI)
        ctx.save_for_backward(L_local, *Wjj, *zs)
        ctx.args = (group, nblk, b)
        return val

    @staticmethod
    def backward(ctx, g):
        group, nblk, b = ctx.args
        me = rank(group)
        L_local, *rest = ctx.saved_tensors
        Wjj, zs = rest[:nblk], rest[nblk:]
        d = zs[0].shape[-1]
        alphas = _dist_backward_solve(L_local, Wjj, zs, group, nblk, b)
        Kinv_rows = _dist_kinv_rows(_dist_tri_inv(L_local, Wjj, group, nblk, b), group, nblk, b)
        alpha_local = alphas[me]
        alpha_flat = torch.cat(alphas, dim=-2)  # (B, n, d)
        gg = g[..., None, None]
        dSigma = gg * 0.5 * (d * Kinv_rows - alpha_local @ alpha_flat.transpose(-1, -2))
        return dSigma, gg * alpha_local, None, None, None


def mvn_nll_rowsharded(Sigma_local, y_local, group, nblk: int, b: int):
    """This rank's PARTIAL of the NLML of y ~ N(0, Sigma), Sigma and y
    row-sharded over ``group`` (``Sigma_local`` (b, n) or (B, b, n),
    ``y_local`` (b, d) or (B, b, d)).

    The partials sum to `ops/linalg.mvn_nll`'s value; the caller reduces
    them with `sum_partials`, which gives every partial the same cotangent:
    the backward (dSigma = 0.5 (d K^-1 - alpha alpha^T), its rows) is the
    gradient of the TOTAL and is exact only under that contract."""
    unbatched = Sigma_local.ndim == 2
    S = Sigma_local[None] if unbatched else Sigma_local
    y = y_local.expand(S.shape[:1] + y_local.shape[-2:])
    out = _MvnNllRowsharded.apply(S, y, group, nblk, b)
    return out[0] if unbatched else out


def _padded_n(n_real, nblk):
    return ((n_real + nblk - 1) // nblk) * nblk


def _pad_rows(a, n_pad):
    """Zero rows appended up to ``n_pad`` (masking is then the static
    predicate global row < n_real)."""
    pad = n_pad - a.shape[0]
    if pad == 0:
        return a
    return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))], dim=0)


def _data(a, like):
    """``a`` (a tensor or an array) on the parameters' device and dtype."""
    return torch.as_tensor(a).to(device=like.device, dtype=like.dtype)


def _col(a):
    return a if a.ndim == 2 else a[:, None]


def _assemble_local(gp, params, x_local, x_full, yv_local, group, b, n_real):
    """This rank's masked (*B, b, n_pad) row slab of Sigma, and the noise.

    K1 builds the slab ``K(x_local, x_full)`` without a nugget (its
    diagonal terms sit at i == j, not at this slab's diagonal, column
    rank * b + i); noise, jitter and ``y_var`` are added there.  Padded
    rows and columns (global index >= n_real) become identity rows; the
    noise floor's and the relative jitter's mean diagonal count only the
    valid rows."""
    me = rank(group)
    r0 = me * b
    n_pad = x_full.shape[0]
    K = gp.kernel.apply(params["kernel"], x_local, x_full)
    valid_r = (r0 + torch.arange(b, device=K.device)) < n_real
    diag_local = K[..., r0:r0 + b].diagonal(dim1=-2, dim2=-1)  # (*B, b)
    diag_mean = psum(torch.where(valid_r, diag_local, torch.zeros_like(diag_local)).sum(-1),
                     group) / n_real
    noise = gp.noise(params, diag_mean)
    jit_val = gp.jitter * diag_mean if gp.relative_jitter else gp.jitter
    extra = (noise + jit_val)[..., None].expand(diag_local.shape)
    if yv_local is not None:
        extra = extra + yv_local
    if n_pad != n_real:
        valid_c = torch.arange(n_pad, device=K.device) < n_real
        K = K * (valid_r[:, None] & valid_c[None, :]).to(K.dtype)
        extra = torch.where(valid_r, extra, torch.ones_like(extra))
    Sigma = torch.cat([K[..., :r0], K[..., r0:r0 + b] + torch.diag_embed(extra),
                       K[..., r0 + b:]], dim=-1)
    return Sigma, noise


def _layout(mesh, axis, x, like):
    """(group, nblk, padded n, b, this rank's first row, x padded)."""
    group = mesh.get_group(axis)
    nblk = axis_size(mesh, axis)
    n = _padded_n(x.shape[0], nblk)
    b = n // nblk
    return group, nblk, n, b, rank(group) * b, _pad_rows(_data(x, like), n)


def cigp_nll_nsharded(gp, params, x, y, mesh, axis: str = "n", y_var=None):
    """CIGP NLML with the TRAINING-SET axis sharded over ``mesh[axis]``.

    Semantically ``gp.nll(params, x, y, y_var=y_var)`` (the same noise
    floor, jitter policy and value/gradient), but no rank holds more than
    an (n/P, n) slab of the Gram or its factor.  Any n: rows are padded to
    a multiple of P and masked.  Differentiable with respect to
    ``params``; every rank returns the total."""
    like = tree_leaves(params)[0]
    n_real = x.shape[0]
    group, nblk, n, b, r0, x_p = _layout(mesh, axis, x, like)
    y_p = _pad_rows(_col(_data(y, like)), n)
    yv = None if y_var is None else _pad_rows(_col(_data(y_var, like)), n)[r0:r0 + b, 0]
    params = replicate_tree(params, group)
    Sigma, _ = _assemble_local(gp, params, x_p[r0:r0 + b], x_p, yv, group, b, n_real)
    total = sum_partials(mvn_nll_rowsharded(Sigma, y_p[r0:r0 + b], group, nblk, b), group)
    # each padded identity row added 0.5 d log(2 pi) through the partials
    return total - 0.5 * (n - n_real) * y_p.shape[1] * LOG2PI


def cigp_posterior_nsharded(gp, params, x, y, x_test, mesh, axis: str = "n", y_var=None):
    """CIGP posterior mean (m, d) and diagonal variance (m,) plus the noise
    with the TRAINING-SET axis sharded over ``mesh[axis]``: semantically
    ``gp.predict_diag(params, x, y, x_test, y_var=y_var)``; ``x_test`` is
    replicated.  Collectives: the factorization's, one all-reduce of b x
    m a panel (the forward substitution of the cross-Gram) and one of the
    (m, d) mean; nothing of O(n^2)."""
    like = tree_leaves(params)[0]
    n_real = x.shape[0]
    group, nblk, n, b, r0, x_p = _layout(mesh, axis, x, like)
    y_p = _pad_rows(_col(_data(y, like)), n)
    yv = None if y_var is None else _pad_rows(_col(_data(y_var, like)), n)[r0:r0 + b, 0]
    xt = _data(x_test, like)
    kp = params["kernel"]
    with torch.no_grad():
        x_local = x_p[r0:r0 + b]
        Sigma, noise = _assemble_local(gp, params, x_local, x_p, yv, group, b, n_real)
        L_local, _, Wjj = _dist_chol(Sigma[None], group, nblk, b)
        zs_y = _dist_forward_solve(L_local, Wjj, y_p[None, r0:r0 + b], group, nblk, b)
        alpha_local = _dist_backward_solve(L_local, Wjj, zs_y, group, nblk, b)[rank(group)][0]
        valid_r = (r0 + torch.arange(b, device=like.device)) < n_real
        # padded x rows are zeros, and k(0, x_test) != 0: zero their cross-Gram rows
        K_s = gp.kernel.apply(kp, x_local, xt) * valid_r[:, None].to(like.dtype)  # (b, m)
        mean = all_reduce_sum(K_s.T @ alpha_local, group)
        zs_K = _dist_forward_solve(L_local, Wjj, K_s[None], group, nblk, b)
        explained = sum((z[0] * z[0]).sum(0) for z in zs_K)
        var = torch.clamp(gp.kernel.diag(kp, xt) - explained, min=0.0) + noise
    return mean, var


def make_n_mesh(axis: str = "n", device="cuda"):
    """1-D mesh over the world's ranks with the dim ``axis`` (a world of
    one process is started when none exists; `parallel/mesh.py`)."""
    return make_mesh(axis, device)


def fit_nsharded(gp, params, x, y, mesh, steps: int = 200, lr: float = 1e-2,
                 axis: str = "n", y_var=None):
    """n-axis sharded training in one call: the port's Adam loop
    (`train/fit.py:adam_scan`, NaN last-good rollback included) over
    `cigp_nll_nsharded`.  Returns ``(good_params, losses)``, the last
    verified-finite params, the same on every rank."""
    from fidelityfusion_tpu_torch.train.fit import adam_scan

    like = tree_leaves(params)[0]
    x, y = _data(x, like), _data(y, like)
    y_var = None if y_var is None else _data(y_var, like)
    _, good, losses = adam_scan(
        lambda p: cigp_nll_nsharded(gp, p, x, y, mesh, axis=axis, y_var=y_var),
        params, lr, steps)
    return good, losses


# --------------------------------------------------------------------------
# Restarts x n: the 2-D composition
# --------------------------------------------------------------------------


def make_rn_mesh(n_r: int, n_n: Optional[int] = None, r_axis: str = "r", n_axis: str = "n",
                 device="cuda"):
    """2-D (restarts, n) mesh of ``n_r * n_n`` ranks, the world (``n_n``
    defaults to the world size over ``n_r``).  The restart dim is
    embarrassingly parallel; the n dim carries the factorization's
    collectives."""
    import torch.distributed as dist

    ensure_world(device)
    if n_n is None:
        n_n = dist.get_world_size() // n_r
    return grid_mesh((n_r, n_n), (r_axis, n_axis), device)


def restarts_nll_nsharded(gp, params_batch, x, y, mesh, n_axis: str = "n",
                          r_axis: Optional[str] = None, y_var=None, residual=None, lift=None):
    """Per-restart NLML vector (R,) with the training-set axis sharded over
    ``mesh[n_axis]`` and the restart batch, optionally, over
    ``mesh[r_axis]`` (R divisible by its size): each restart group gets
    its own n-sharded factorization row of the mesh, the local group
    factored as a batch (K3a).  ``params_batch`` has a leading axis R on
    every leaf; the sum of the returned vector is the joint restart loss.

    ``residual``: ``(y_low, y_high, shift, scale)``, the AR rho stage,
    whose target ``(y_high - rho y_low - shift) / scale`` is rebuilt per
    restart from row slabs (params ``{"gp": ..., "rho": (R,)}``, ``y``
    ignored).  ``lift``: a `TensorLinear`; with ``residual``, the CIGAR
    target ``(y_high - TL(y_low) - shift) / scale`` through ``p["tl"]``
    (row-local, so no extra collective)."""
    like = tree_leaves(params_batch)[0]
    n_real = x.shape[0]
    group, nblk, n, b, r0, x_p = _layout(mesh, n_axis, x, like)
    rows = slice(r0, r0 + b)
    yv = None if y_var is None else _pad_rows(_col(_data(y_var, like)), n)[rows, 0]
    # the parameters' partial gradients sum over every rank that saw them
    pb = replicate_tree(params_batch, None if r_axis is not None else group)
    if r_axis is not None:
        pb = shard_leading_axis(pb, mesh, r_axis)
    if residual is not None:
        yl_r, yh_r, shift, scale = residual
        yl = _pad_rows(_col(_data(yl_r, like)), n)[rows]
        yh = _pad_rows(_col(_data(yh_r, like)), n)[rows]
        gp_p = pb["gp"]
        if lift is not None:
            lifted = lift.apply(pb["tl"], yl.reshape((b,) + tuple(lift.l_shape)))
            tgt = (yh - lifted.reshape(lifted.shape[0], b, -1) - shift) / scale
        else:
            tgt = (yh - pb["rho"].reshape(-1, 1, 1) * yl - shift) / scale
        if n != n_real:
            # zero-padded rows map to -shift/scale: mask them to 0
            valid = (r0 + torch.arange(b, device=like.device)) < n_real
            tgt = tgt * valid[:, None].to(tgt.dtype)
        d_out = yh.shape[1]
    else:
        gp_p = pb
        tgt = _pad_rows(_col(_data(y, like)), n)[rows]
        d_out = tgt.shape[1]
    Sigma, _ = _assemble_local(gp, gp_p, x_p[rows], x_p, yv, group, b, n_real)
    losses = sum_partials(mvn_nll_rowsharded(Sigma, tgt, group, nblk, b), group)
    if r_axis is not None:
        losses = gather_rows(losses, mesh.get_group(r_axis))
    return losses - 0.5 * (n - n_real) * d_out * LOG2PI


def fit_restarts_nsharded(gp, params_batch, x, y, mesh, steps: int = 200, lr: float = 1e-2,
                          n_axis: str = "n", r_axis: Optional[str] = None, y_var=None,
                          residual=None, lift=None):
    """Restart-ladder training over the (restarts x n) mesh, as the JAX
    package's: one Adam loop advances every restart (the summed NLMLs),
    each restart's factorization n-sharded; a restart whose loss or update
    is not finite keeps its last finite params (its Adam moments run on,
    as optax's do); the winner is the lowest final NLML re-evaluated at
    those params, non-finite ones last.  Returns ``(best_params,
    per_restart_final_losses)``, the same on every rank."""
    from fidelityfusion_tpu_torch.train.fit import B1, B2, EPS, _bcast

    def losses_fn(pb):
        return restarts_nll_nsharded(gp, pb, x, y, mesh, n_axis=n_axis, r_axis=r_axis,
                                     y_var=y_var, residual=residual, lift=lift)

    good = [a.detach() for a in tree_leaves(params_batch)]
    mu = [torch.zeros_like(a) for a in good]
    nu = [torch.zeros_like(a) for a in good]
    count = torch.zeros((), dtype=good[0].dtype, device=good[0].device)
    for _ in range(steps):
        ps = [a.clone().requires_grad_(True) for a in good]
        with torch.enable_grad():
            ls = losses_fn(tree_unflatten(params_batch, ps))
            grads = torch.autograd.grad(ls.sum(), ps, allow_unused=True)
        count = count + 1
        one = torch.ones_like(count)
        bc1, bc2 = 1 - torch.pow(one * B1, count), 1 - torch.pow(one * B2, count)
        finite = torch.isfinite(ls.detach())
        new = []
        for i, (a, g) in enumerate(zip(good, grads)):
            g = torch.zeros_like(a) if g is None else g
            mu[i] = (1 - B1) * g + B1 * mu[i]
            nu[i] = (1 - B2) * g ** 2 + B2 * nu[i]
            upd = (mu[i] / bc1) / (torch.sqrt(nu[i] / bc2) + EPS) * (-lr)
            finite = finite & torch.isfinite(upd).reshape(upd.shape[0], -1).all(-1)
            new.append(a + upd)
        good = [torch.where(_bcast(finite, a), a_new, a) for a, a_new in zip(good, new)]
    good_tree = tree_unflatten(params_batch, good)
    with torch.no_grad():
        final = losses_fn(good_tree)
    final = torch.where(torch.isfinite(final), final, torch.full_like(final, float("inf")))
    best_i = int(torch.argmin(final))
    return tree_map(lambda a: a[best_i], good_tree), final
