"""Kronecker / tensor-algebra primitives for high-order GPs.

Port of `fidelityfusion_tpu/ops/kron.py`: mode products are batched
matmuls, per-mode symmetric eigendecompositions are `torch.linalg.eigh`,
and the Kronecker covariance ``K_0 (x) K_1 (x) ... (x) K_M`` is never
formed.  Every function takes an optional leading restart dimension R:
a mode Gram is ``(n, n)`` or ``(R, n, n)``, the targets ``(n, d_1..d_M)``
(shared by every restart) or ``(R, n, d_1..d_M)``, the noise a scalar or
``(R,)``; ``eigh`` then runs batched over R and the loss is ``(R,)``.

`kron_nlml` is a `torch.autograd.Function` whose backward is the closed
form of the JAX package's `_kron_nlml_bwd`: it reuses the forward's
eigenpairs, so the backward is mode-product GEMMs only, with no autograd
through ``eigh``.  The tracked variants warm-start mode 0's eigenbasis
across training steps (`ops/spectral.py`) and share that backward.

The port departs from the JAX package in its precision here.  A smooth
SE Gram's small eigenvalues, which the Kronecker product multiplies by
the other modes' eigenvalue products (up to ~1e6 at hogp1024's (32, 32,
32) grids), are lost both to a float32 ``eigh`` (at hogp1024 the float32
NLML was 5e-2 off float64 on an H100, 7e-3 on the CPU) and to the
float32 rounding of the Gram itself (1e-2 to 4e-2 off at trained
hogp1024 parameters, on four data seeds; the arithmetic after the
eigendecomposition costs 1e-7).  So `models/hogp.py` builds its Grams in
float64 (K1's float64 instance on the card), `eigh_pairs` decomposes in
float64, and `to_targets` brings the eigenpairs (and `predict`'s mode
Grams) back to the targets' float32 for the rest of the NLML, its
backward and the posterior; the backward's last step, each mode Gram's
cotangent rotated back from its eigenbasis, runs in the Gram's float64
(`_kron_nlml_bwd`).  And
``torch.linalg.eigh`` raises where the JAX package's returns NaN (it
checks the solver's status, on the CPU and on the card), so a matrix with
a non-finite entry is swapped for the identity before ``eigh`` and its
eigenvalues come back NaN: that restart's loss is NaN (and the trainer
rolls it back) while the others train on, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

LOG2PI = math.log(2.0 * math.pi)


def mode_dot(tensor: torch.Tensor, matrix: torch.Tensor, mode: int) -> torch.Tensor:
    """n-mode product: contract ``matrix``'s last axis with ``tensor``'s axis
    ``mode`` (tensorly's `mode_dot`).  A ``(J, I)`` matrix acts on every
    leading axis alike; a batched ``(R, J, I)`` matrix takes the tensor's
    axis 0 as its batch (size R or 1), and ``mode`` counts that axis."""
    nb = matrix.ndim - 2
    shape = tensor.shape
    pre = math.prod(shape[nb:mode])
    post = math.prod(shape[mode + 1:])
    t = tensor.reshape(shape[:nb] + (pre, shape[mode], post))
    if post == 1:  # the last mode: one GEMM against the matrix's transpose
        out = t[..., 0] @ matrix.transpose(-1, -2)
    else:
        out = matrix.unsqueeze(-3) @ t
    lead = out.shape[:nb]
    return out.reshape(lead + tuple(shape[nb:mode]) + (matrix.shape[-2],)
                       + tuple(shape[mode + 1:]))


def multi_mode_dot(tensor: torch.Tensor, matrices: Sequence[torch.Tensor],
                   modes: Sequence[int] = None) -> torch.Tensor:
    """Chain of mode products over all (or the given) modes."""
    if modes is None:
        modes = range(len(matrices))
    out = tensor
    for mat, mode in zip(matrices, modes):
        out = mode_dot(out, mat, mode)
    return out


def to_targets(tensors: Sequence[torch.Tensor], y: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``tensors`` of the float64 Gram side (eigenpairs, mode Grams) in the
    targets' dtype: the one place the port's precision split (module
    docstring) is crossed back."""
    return tuple(t.to(y.dtype) for t in tensors)


def eigh_pairs(K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric eigendecomposition (ascending values) of ``(K + K^T) / 2``,
    ``K`` ``(n, n)`` or ``(R, n, n)``, as ``jnp.linalg.eigh`` symmetrizes its
    input: ``(values, vectors)`` in K's dtype, decomposed in float64 (see
    the module docstring).  A matrix with a non-finite entry gives NaN
    values and identity vectors, and raises nothing."""
    bad = ~torch.isfinite(K).all(-1).all(-1)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    K = torch.where(bad[..., None, None], eye, 0.5 * (K + K.transpose(-1, -2)))
    w, V = torch.linalg.eigh(K.double())
    w, V = w.to(K.dtype), V.to(K.dtype)
    return torch.where(bad[..., None], torch.full_like(w, float("nan")), w), V


def _clamp_psd(lams):
    """Clamp per-mode eigenvalues at zero: every mode Gram is PSD by
    construction, but fp32 eigh returns small negatives, which the
    Kronecker product multiplies by the other modes' eigenvalues (up to
    ~1e5 at (32, 32, 32)) into a negative A and a NaN log.  NaN stays NaN."""
    return [torch.clamp(lam, min=0.0) for lam in lams]


def rank1_tucker(factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Outer product of vectors: ``out[..., i0, ..., iM] = prod_m
    factors[m][..., i_m]``; every factor ``(d_m,)`` or ``(R, d_m)``."""
    out = factors[0]
    nb = out.ndim - 1
    for f in factors[1:]:
        ones = (1,) * (out.ndim - nb)
        out = out[..., None] * f.reshape(f.shape[:-1] + ones + f.shape[-1:])
    return out


def _batched(Ks, y, noise):
    """Ks, y and noise with one leading batch axis each (R, or 1 where the
    argument has none)."""
    Kb = [K if K.ndim == 3 else K[None] for K in Ks]
    yb = y if y.ndim == len(Ks) + 1 else y[None]
    nb = noise.reshape(-1)
    return Kb, yb, nb


def _unbatch(g, ndim):
    """Gradient ``g`` (with a batch axis) summed over it for an input of
    ``ndim`` axes that had none."""
    return g if g.ndim == ndim else g.sum(0)


def _loss_and_saved(eigvals, eigvecs, y, noise):
    """The forward's shared tail: A, T1 and the element-normalized NLML
    (``(b,)``), all batched."""
    eigvals = _clamp_psd(eigvals)
    M1 = len(eigvals)
    A = rank1_tucker(eigvals) + noise.reshape((-1,) + (1,) * M1)
    T1 = multi_mode_dot(y, [V.transpose(-1, -2) for V in eigvecs],
                        modes=range(1, M1 + 1))
    nd = float(math.prod(T1.shape[1:]))
    dims = tuple(range(1, M1 + 1))
    loss = 0.5 * (nd * LOG2PI + torch.log(A).sum(dims) + (T1 * T1 / A).sum(dims)) / nd
    return loss, eigvals, A, T1


def _kron_nlml_bwd(eigvals, eigvecs, A, T1, t, need_K, need_y, need_noise, k_dtypes):
    """Closed-form VJP (`fidelityfusion_tpu/ops/kron.py:_kron_nlml_bwd`):
    ``dK_m = s V_m (diag(w_m) - G_m G_m^T) V_m^T`` with ``s = t / (2 nd)``,
    ``dy = (t / nd) multi_mode_dot(beta, V)``, ``dnoise = s (sum U - sum
    beta^2)``; batched, ``t`` of shape ``(b,)``.  The eigen-space cotangent
    ``diag(w_m) - G_m G_m^T`` is rotated back to the Gram's basis in the
    Gram's dtype ``k_dtypes[m]`` (float64): its two terms nearly cancel in
    the gradient of a length scale or signal variance, and a float32
    rotation loses that difference (hogp1024's signal-variance gradient
    came out with the wrong sign; `scripts/hogp_grad_precision.py`)."""
    M1 = len(eigvals)
    nd = float(math.prod(T1.shape[1:]))
    dims = tuple(range(1, M1 + 1))
    U = 1.0 / A
    beta = T1 * U
    del T1
    scale = t * 0.5 / nd  # (b,)
    sqrt_lams = [torch.sqrt(torch.clamp(lam, min=0.0)) for lam in eigvals]
    dKs = []
    for m in range(M1):
        if not need_K[m]:
            dKs.append(None)
            continue
        others = [j for j in range(M1) if j != m]
        w = multi_mode_dot(U, [eigvals[j][:, None, :] for j in others],
                           modes=[j + 1 for j in others]).reshape(U.shape[0], -1)
        gamma = beta * rank1_tucker([sqrt_lams[j] if j != m else torch.ones_like(sqrt_lams[j])
                                     for j in range(M1)])
        G = torch.movedim(gamma, m + 1, 1).reshape(gamma.shape[0], gamma.shape[m + 1], -1)
        del gamma
        B = G @ G.transpose(-1, -2)
        del G
        D = (torch.diag_embed(w) - B).to(k_dtypes[m])
        V = eigvecs[m].to(k_dtypes[m])
        dKs.append(scale.to(V.dtype)[:, None, None] * (V @ D @ V.transpose(-1, -2)))
    dy = None
    if need_y:
        dy = (t / nd).reshape((-1,) + (1,) * M1) * multi_mode_dot(beta, list(eigvecs),
                                                                  modes=range(1, M1 + 1))
    dnoise = scale * (U.sum(dims) - (beta * beta).sum(dims)) if need_noise else None
    return dKs, dy, dnoise


class _KronNLML(torch.autograd.Function):
    """Inputs: ``spec`` (None for the exact NLML, else the tracking spec:
    ``(kind, step, arg1, arg2, sweeps)``), y, noise, V0 (or None), last_res
    (or None), then the mode Grams.  Outputs loss (and, tracked, V0's
    successor and the residual, both without gradient)."""

    @staticmethod
    def forward(ctx, spec, y, noise, V0, last_res, *Ks):
        Kb, yb, nb = _batched(Ks, y, noise)
        if spec is None:
            pairs = [eigh_pairs(K) for K in Kb]
            res = None
        else:
            from fidelityfusion_tpu_torch.ops import spectral

            kind, step, a1, a2, sweeps = spec
            V0b = (V0 if V0.ndim == 3 else V0[None]).to(Kb[0].dtype)
            if kind == "static":
                tracked = spectral.tracked_eigh(Kb[0], V0b, step, a1, sweeps)
            else:
                tracked = spectral.tracked_eigh_adaptive(Kb[0], V0b, last_res, step, a1, a2,
                                                         sweeps)
            lam0, V0n, res = to_targets(tracked, y)
            pairs = [(lam0, V0n)] + [eigh_pairs(K) for K in Kb[1:]]
        pairs = [to_targets(p, y) for p in pairs]
        eigvals = [p[0] for p in pairs]
        eigvecs = [p[1] for p in pairs]
        loss, eigvals, A, T1 = _loss_and_saved(eigvals, eigvecs, yb, nb)
        ctx.save_for_backward(A, T1, *eigvals, *eigvecs)
        ctx.M1 = len(Ks)
        ctx.shapes = (y.ndim, noise.shape, [K.ndim for K in Ks])
        ctx.k_dtypes = [K.dtype for K in Ks]
        batched = any(K.ndim == 3 for K in Ks) or y.ndim == len(Ks) + 1
        loss = loss if batched else loss[0]
        if spec is None:
            return loss
        V_new = eigvecs[0] if V0.ndim == 3 else eigvecs[0][0]
        res = res if V0.ndim == 3 else res.reshape(())
        ctx.mark_non_differentiable(V_new, res)
        return loss, V_new, res

    @staticmethod
    def backward(ctx, t, *_aux):
        A, T1, *rest = ctx.saved_tensors
        M1 = ctx.M1
        eigvals, eigvecs = rest[:M1], rest[M1:]
        y_ndim, noise_shape, K_ndims = ctx.shapes
        need = ctx.needs_input_grad
        tb = t.reshape(-1).expand(A.shape[0])
        dKs, dy, dnoise = _kron_nlml_bwd(eigvals, eigvecs, A, T1, tb, need[5:], need[1],
                                         need[2], ctx.k_dtypes)
        dKs = [None if g is None else _unbatch(g, nd) for g, nd in zip(dKs, K_ndims)]
        if dy is not None:
            dy = _unbatch(dy, y_ndim)
        if dnoise is not None:
            dnoise = (dnoise.reshape(noise_shape) if math.prod(noise_shape) == dnoise.numel()
                      else dnoise.sum().reshape(noise_shape))
        return (None, dy, dnoise, None, None, *dKs)


def _noise_tensor(noise, y):
    return (noise if torch.is_tensor(noise)
            else torch.tensor(float(noise), dtype=y.dtype, device=y.device))


def kron_nlml(Ks: Sequence[torch.Tensor], y: torch.Tensor, noise) -> torch.Tensor:
    """Element-normalized NLML of a Kronecker-structured GP,

        Sigma = K_0 (x) K_1 (x) ... (x) K_M + noise * I,
        loss  = 0.5 (nd log 2pi + sum log A + vec(y)^T Sigma^-1 vec(y)) / nd,

    with the closed-form backward that reuses the forward's eigenpairs."""
    return _KronNLML.apply(None, y, _noise_tensor(noise, y), None, None, *Ks)


def tracked_kron_nlml(refresh_every: int = 64, sweeps: int = 1):
    """`kron_nlml` with mode 0's eigenbasis warm-started across training
    steps (`ops/spectral.py:tracked_eigh`): a full ``eigh`` on every
    ``refresh_every``-th step, Jacobi sweeps in between.  Returns ``f(Ks, y,
    noise, V0, step) -> (loss, V_new, res)`` with ``step`` the trainer's
    Python int step counter (every restart refreshes on the same step);
    ``V_new`` and ``res`` carry no gradient."""
    refresh_every, sweeps = int(refresh_every), int(sweeps)

    def f(Ks, y, noise, V0, step):
        spec = ("static", int(step), refresh_every, None, sweeps)
        return _KronNLML.apply(spec, y, _noise_tensor(noise, y), V0, None, *Ks)

    return f


def tracked_kron_nlml_adaptive(max_gap: int = 128, res_threshold: float = 0.05,
                               sweeps: int = 1):
    """`tracked_kron_nlml` with the residual-gated refresh
    (`ops/spectral.py:tracked_eigh_adaptive`).  Unbatched training only:
    the gate reads the previous residual on the host, one sync a step.
    Returns ``f(Ks, y, noise, V0, last_res, step) -> (loss, V_new, res)``."""
    max_gap, res_threshold, sweeps = int(max_gap), float(res_threshold), int(sweeps)

    def f(Ks, y, noise, V0, last_res, step):
        spec = ("adaptive", int(step), max_gap, res_threshold, sweeps)
        return _KronNLML.apply(spec, y, _noise_tensor(noise, y), V0, last_res, *Ks)

    return f
