"""n-axis sharded Kronecker/HOGP NLML: distributed mode products and
tracked-spectrum training over the ranks.

Port of `fidelityfusion_tpu/parallel/kron_nsharded.py`.  Once spectral
tracking replaces the per-step ``eigh`` (`ops/spectral.py`), a tracked
HOGP step is a chain of n^3-class products (Rayleigh-Ritz, Newton-Schulz
orthonormalization, basis rotations) and n^2 D-class mode products; here
they are laid out over the ranks of one mesh dim.  Per rank, b = n/P:

  * K0, the mode-0 Gram: a (b, n) row slab from ``(x_local, x_full)`` by
    K1's float64 instance, with the jitter and ``y_var`` added at this
    slab's diagonal (column rank * b + i);
  * y: its b data rows; A (the eigenvalue tensor) and T1 (the rotated y):
    b rows of the mode-0 EIGEN axis - the memory-dominant objects;
  * V (the mode-0 eigenbasis) and B (the Rayleigh-Ritz matrix): replicated
    (n, n); the mode m >= 1 Grams and their eigenpairs: replicated.

Each n^3 product becomes n^3 / P local work and one all-reduce of n^2: a
row-sharded product against a replicated matrix is local, a contraction
over the sharded rows is all-reduced.  The scheduled full ``eigh`` runs on
the all-gathered Gram, replicated on every rank; `fit_hogp_nsharded`
defaults to pure tracking (one refresh, at step 0).

The port's Kronecker path builds its Grams in float64 and decomposes them
in float64 (`models/hogp.py:HOGP._grams`, `ops/kron.py`: a listed
departure from the JAX package's float32), and so does this one: the
Jacobi sweeps run in the Gram's float64, then eigenpairs cross back to the
targets' float32 (`ops/kron.py:to_targets`) for the NLML and its
backward, whose Gram cotangents are formed in float64 again.  At one rank
the loss is the port's `HOGP.nll_tracked`.

Gradients follow `parallel/nsharded.py`: each rank's partial loss has a
closed-form backward (the JAX package's `f_bwd`, blockwise) giving the
exact row blocks of dK0 and dy and PARTIAL cotangents of the mode Grams
and the noise; the parameters' partials are summed by `replicate_tree`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from fidelityfusion_tpu_torch.ops.kron import (
    _clamp_psd, eigh_pairs, multi_mode_dot, rank1_tucker, to_targets)
from fidelityfusion_tpu_torch.ops.spectral import jacobi_generator, off_diagonal_residual
from fidelityfusion_tpu_torch.parallel.collectives import (
    all_gather_rows, all_reduce_sum, rank, replicate_tree, sum_partials)
from fidelityfusion_tpu_torch.parallel.mesh import axis_size
from fidelityfusion_tpu_torch.parallel.nsharded import _data
from fidelityfusion_tpu_torch.utils.tree import tree_leaves, tree_map

LOG2PI = math.log(2.0 * math.pi)


def _psum_rowcontract(A_local, B_local, group):
    """sum_k A[k, :]^T B[k, :] over the sharded row axis, replicated."""
    return all_reduce_sum(A_local.T @ B_local, group)


def _jacobi_refine_sharded(K_local, V, group, b, sweeps=1):
    """`ops/spectral.py:jacobi_refine` with every n^3 product distributed
    over ``group``: ``K_local`` the (b, n) row block, ``V`` replicated
    (n, n).  Returns ``(w, V', res)``, replicated."""
    r0 = rank(group) * b
    rows = slice(r0, r0 + b)
    eye = torch.eye(V.shape[0], dtype=V.dtype, device=V.device)
    B = _psum_rowcontract(V[rows], K_local @ V, group)  # V^T K V
    for _ in range(sweeps):
        Q_local = eye[rows] + jacobi_generator(B)[rows]  # I + S, row-sharded
        for _ns in range(3):  # Newton-Schulz: Q <- Q (3I - Q^T Q) / 2
            G = all_reduce_sum(Q_local.T @ Q_local, group)
            Q_local = Q_local @ (1.5 * eye - 0.5 * G)
        # B <- Q^T B Q, V <- V Q: (X Q)[i, j] = sum_k X[i, k] Q[k, j], the
        # sum over Q's sharded rows k taken from X's column block k
        QtB = _psum_rowcontract(Q_local, B[rows], group)
        B = all_reduce_sum(QtB[:, rows] @ Q_local, group)
        V = all_reduce_sum(V[:, rows] @ Q_local, group)
    w, res = off_diagonal_residual(B)
    return w, V, res


def _tracked_eigh_sharded(K_local, V_prev, step, group, b, refresh_every, sweeps):
    """`ops/spectral.py:tracked_eigh` over the ranks: the scheduled
    refresh is one replicated ``eigh`` of the all-gathered Gram; tracked
    steps run the distributed Jacobi refinement."""
    if int(step) % refresh_every == 0:
        w, V = eigh_pairs(all_gather_rows(K_local, group))
        return w, V, torch.zeros((), dtype=K_local.dtype, device=K_local.device)
    return _jacobi_refine_sharded(K_local, V_prev.to(K_local.dtype), group, b, sweeps)


class _TrackedKronNLMLRowsharded(torch.autograd.Function):
    """This rank's partial of the element-normalized tracked Kronecker NLML
    (`ops/kron.py:tracked_kron_nlml`), with ``V_new`` and the residual: the
    JAX package's `_tracked_kron_nlml_rowsharded` custom VJP.

    Inputs: ``spec = (step, refresh_every, sweeps, group, nblk, b)``, the
    rank's data rows ``y_local (b, d_1..d_M)``, the noise, ``V_prev``,
    ``K0_local (b, n)`` and the mode Grams.  Backward: the exact row blocks
    of dK0 and dy, partial cotangents of the mode Grams and the noise."""

    @staticmethod
    def forward(ctx, spec, y_local, noise, V_prev, K0_local, *K_modes):
        step, refresh_every, sweeps, group, nblk, b = spec
        rows = slice(rank(group) * b, rank(group) * b + b)
        lam0, V, res = to_targets(_tracked_eigh_sharded(
            K0_local, V_prev, step, group, b, refresh_every, sweeps), y_local)
        pairs = [to_targets(eigh_pairs(K), y_local) for K in K_modes]
        eigvals = _clamp_psd([lam0] + [p[0] for p in pairs])
        eigvecs = [V] + [p[1] for p in pairs]
        M1 = len(eigvals)
        A_local = rank1_tucker([eigvals[0][rows]] + eigvals[1:]) + noise
        # V^T y: a partial over this rank's data rows, summed; keep my eigen rows
        T1_flat = all_reduce_sum(V[rows].T @ y_local.reshape(y_local.shape[0], -1), group)[rows]
        T1_local = multi_mode_dot(T1_flat.reshape(y_local.shape),
                                  [Vm.T for Vm in eigvecs[1:]], modes=range(1, M1))
        nd = float(V.shape[0] * math.prod(y_local.shape[1:]))
        loss = 0.5 * (nd * LOG2PI / nblk + torch.log(A_local).sum()
                      + (T1_local * T1_local / A_local).sum()) / nd
        ctx.save_for_backward(A_local, T1_local, *eigvals, *eigvecs)
        ctx.args = (group, nblk, b, M1, nd, K0_local.dtype, [K.dtype for K in K_modes])
        ctx.mark_non_differentiable(V, res)
        return loss, V, res

    @staticmethod
    def backward(ctx, t, _t_v, _t_res):
        group, nblk, b, M1, nd, k0_dtype, km_dtypes = ctx.args
        A_local, T1_local, *rest = ctx.saved_tensors
        eigvals, eigvecs = rest[:M1], rest[M1:]
        rows = slice(rank(group) * b, rank(group) * b + b)
        V = eigvecs[0]
        scale = t * 0.5 / nd
        U_local = 1.0 / A_local
        beta_local = T1_local * U_local
        sqrt_lams = [torch.sqrt(torch.clamp(lam, min=0.0)) for lam in eigvals]
        lam0_local = eigvals[0][rows]
        sq0_local = sqrt_lams[0][rows]
        others = list(range(1, M1))

        # dK0, exact row block over data rows:
        # scale * (V diag(w0) V^T - H H^T), H = V @ unfold0(gamma0), the
        # products in the Gram's float64: the two terms nearly cancel in a
        # length scale's or signal variance's gradient (`ops/kron.py:
        # _kron_nlml_bwd`)
        w0 = all_gather_rows(multi_mode_dot(
            U_local, [eigvals[j].reshape(1, -1) for j in others], modes=others).reshape(b), group)
        gamma0 = beta_local * rank1_tucker([torch.ones_like(sq0_local)] + sqrt_lams[1:])
        V64 = V.to(k0_dtype)
        H = all_reduce_sum(V64[:, rows] @ gamma0.reshape(b, -1).to(k0_dtype), group)  # (n, D)
        dK0 = scale.to(k0_dtype) * ((V64[rows] * w0.to(k0_dtype)[None, :]) @ V64.T
                                    - H[rows] @ H.T)
        del H

        # dK_m, m >= 1: partials (the eigen rows of mode 0 are this rank's)
        dKms = []
        lam0_b = lam0_local.reshape((b,) + (1,) * (M1 - 1))
        Um = (lam0_b * U_local).sum(0, keepdim=True)
        for m, dt in zip(others, km_dtypes):
            others_m = [j for j in others if j != m]
            wm = multi_mode_dot(Um, [eigvals[j].reshape(1, -1) for j in others_m],
                                modes=others_m).reshape(-1)
            gamma_m = beta_local * rank1_tucker(
                [sq0_local] + [sqrt_lams[j] if j != m else torch.ones_like(sqrt_lams[j])
                               for j in others])
            Gm = torch.movedim(gamma_m, m, 0).reshape(gamma_m.shape[m], -1)
            Dm = (torch.diag(wm) - Gm @ Gm.T).to(dt)
            Vm = eigvecs[m].to(dt)
            dKms.append(scale.to(dt) * (Vm @ Dm @ Vm.T))

        # dy, exact row block over data rows
        beta_rot = multi_mode_dot(beta_local, list(eigvecs[1:]), modes=others).reshape(b, -1)
        dy = (t / nd) * all_reduce_sum(V[:, rows] @ beta_rot, group)[rows].reshape(A_local.shape)
        dnoise = scale * (U_local.sum() - (beta_local * beta_local).sum())
        return (None, dy, dnoise, None, dK0, *dKms)


def _k0_slab(hogp, kp64, x_local, x, extra, r0):
    """K0's (b, n) row slab in float64 (K1's cross-Gram) with ``extra``
    (the jitter and ``y_var``) at its diagonal, column ``r0 + i``."""
    f64 = torch.float64
    K = hogp.kernel.apply(kp64, x_local.to(f64), x.to(f64))
    b = x_local.shape[0]
    return torch.cat([K[:, :r0], K[:, r0:r0 + b] + torch.diag_embed(extra), K[:, r0 + b:]],
                     dim=1)


def hogp_nll_tracked_nsharded(hogp, params, aux, step, x, y, mesh, axis: str = "n",
                              refresh_every: int = 64, sweeps: int = 1, y_var=None,
                              residual=None) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                                          torch.Tensor]]:
    """`models/hogp.py:HOGP.nll_tracked` with the TRAINING-SET axis sharded
    over ``mesh[axis]``: the same value and gradients, threaded through
    `train/fit.py:adam_scan_aux` (``step`` its Python int step), but no rank
    holds the n x n Gram or the full A and T1 tensors.  ``aux = (V_prev,
    max_res)``, V_prev the replicated tracked basis.  n must divide by the
    axis size.

    ``residual``: ``(tl, y_low, y_high, shift, scale)``, the GAR residual
    target ``(Y_hi - TL(Y_lo) - shift) / scale`` built from row slabs
    (TensorLinear acts on the output modes, so it is row-local) with the
    lift trained through the loss; ``params`` is then ``{"hogp": ...,
    "tl": ...}`` and ``y`` is ignored.  Returns ``(loss, (V_new,
    max_res))``, the same on every rank."""
    like = tree_leaves(params)[0]
    group = mesh.get_group(axis)
    nblk = axis_size(mesh, axis)
    n = x.shape[0]
    if n % nblk:
        raise ValueError(f"n={n} not divisible by mesh axis size {nblk}")
    b = n // nblk
    r0 = rank(group) * b
    rows = slice(r0, r0 + b)
    V_prev, max_res = aux
    params = replicate_tree(params, group)
    x = _data(x, like)
    if residual is not None:
        tl, yl_r, yh_r, shift, scale = residual
        hp = params["hogp"]
        y_use = (_data(yh_r, like)[rows] - tl.apply(params["tl"], _data(yl_r, like)[rows])
                 - shift) / scale
    else:
        hp = params
        y_use = _data(y, like)[rows]
    f64 = torch.float64
    kp = tree_map(lambda a: a.to(f64), hp["kernel"])
    extra = torch.full((b,), hogp.jitter, dtype=f64, device=x.device)
    if y_var is not None:
        extra = extra + _data(y_var, like).to(f64).reshape(-1)[rows]
    K0_local = _k0_slab(hogp, kp, x[rows], x, extra, r0)
    K_modes = [hogp._mode_gram(kp, g.to(f64)) for g in hogp.grids(hp)]
    spec = (int(step), int(refresh_every), int(sweeps), group, nblk, b)
    loss_p, V_new, res = _TrackedKronNLMLRowsharded.apply(
        spec, y_use, hogp.noise(hp), V_prev, K0_local, *K_modes)
    return sum_partials(loss_p, group), (V_new, torch.maximum(max_res, res))


def fit_hogp_nsharded(hogp, params, x, y, mesh, steps: int = 200, lr: float = 1e-2,
                      axis: str = "n", refresh_every: Optional[int] = None, sweeps: int = 1,
                      y_var=None, residual=None):
    """n-axis sharded HOGP training in one call: the port's aux-carry Adam
    loop (`train/fit.py:adam_scan_aux`, NaN last-good rollback included)
    over `hogp_nll_tracked_nsharded`.  ``refresh_every`` defaults to pure
    tracking (one replicated ``eigh`` at step 0, product-only distributed
    steps after); pass e.g. 64 for the bounded-staleness schedule.
    Returns ``(good_params, losses, (V, max_res))``."""
    from fidelityfusion_tpu_torch.train.fit import adam_scan_aux

    like = tree_leaves(params)[0]
    if refresh_every is None:
        refresh_every = max(steps + 1, 2)
    x = _data(x, like)
    y = None if y is None else _data(y, like)
    if residual is not None:
        tl, yl, yh, shift, scale = residual
        residual = (tl, _data(yl, like), _data(yh, like), shift, scale)

    def loss_fn(p, aux, step):
        return hogp_nll_tracked_nsharded(hogp, p, aux, step, x, y, mesh, axis=axis,
                                         refresh_every=refresh_every, sweeps=sweeps,
                                         y_var=y_var, residual=residual)

    aux0 = hogp.tracking_aux0(x.shape[0], device=like.device)
    _, good, losses, aux = adam_scan_aux(loss_fn, params, aux0, lr, steps)
    return good, losses, aux
