"""Warm-started spectral tracking for symmetric eigendecompositions.

Port of `fidelityfusion_tpu/ops/spectral.py`.  Inside an Adam training
loop the HOGP mode-0 Gram changes by O(lr) a step, so the previous step's
eigenbasis nearly diagonalizes the new one.  Tracking refines it with
GEMMs only:

    B = V_prev^T K V_prev                 (Rayleigh-Ritz, 2 GEMMs)
    repeat `sweeps` times:
        t_ij = exact 2x2 Jacobi tangent of (diag(B), B_ij)
        Q    = orthonormalize(I + S)      (Newton-Schulz steps, GEMMs)
        B    = Q^T B Q;  V = V Q
    w = diag(B)

The exact tangent saturates at 45 degrees for clustered eigenvalues
instead of dividing by a vanishing gap; a Frobenius cap on S keeps I + S
inside the Newton-Schulz convergence ball.  A full ``eigh`` every
``refresh_every`` steps bounds the staleness.  Every product is a full
fp32 matmul: the callers keep TF32 off (``torch.backends.cuda.matmul.
allow_tf32`` False, as PyTorch's default), as the JAX package's HIGHEST
precision asks.

The refresh predicate depends on the step counter only, a Python int, so
it is a host branch and every restart of a batch refreshes on the same
step (the JAX package's unbatched ``lax.cond``).  Everything takes an
optional leading restart dimension.  `jacobi_refine` returns the relative
off-diagonal residual ``||B - diag(B)||_F / ||B||_F``, which callers thread
through training as a running max.

Two host-side counters, keyed by the matrix size n, count the tracking's
work: full ``eigh`` refreshes (`_refresh`) and Jacobi refinements
(`jacobi_refine`), one per call over a batch of restarts; two more count
every `kron.eigh_pairs` call by the route it took, K5 or
``torch.linalg.eigh``.  They are plain integers bumped on the host, so they
never wait for the device; read them with `spectral_counts` and zero them
with `reset_spectral_counts`, as `ops/cuda.py:launch_counts`.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Tuple

import torch

from fidelityfusion_tpu_torch.ops import kron
from fidelityfusion_tpu_torch.ops.kron import eigh_pairs

# Frobenius cap on the rotation generator: sigma(I + S) <= sqrt(1 + 0.7^2)
# keeps the Newton-Schulz map x(3 - x^2)/2 well inside its convergence ball.
_MAX_S_NORM = 0.7

REFRESHES: Counter = Counter()  # n -> full eigh refreshes
REFINEMENTS: Counter = Counter()  # n -> Jacobi refinements
# every counter by its name in `spectral_counts` (`train/fit.py` adds a
# replayed CUDA graph's counts to them)
COUNTERS: Dict[str, Counter] = {"refresh": REFRESHES, "jacobi": REFINEMENTS,
                                "small_eigh": kron.SMALL_EIGH_CALLS,
                                "library_eigh": kron.LIBRARY_EIGH_CALLS}


def spectral_counts() -> Dict[str, Dict[int, int]]:
    """``{"refresh": {n: calls}, "jacobi": {n: calls}, "small_eigh": {n:
    calls}, "library_eigh": {n: calls}}`` since the last
    `reset_spectral_counts`: the last two are `kron.eigh_pairs`' calls
    through K5 and through ``torch.linalg.eigh``."""
    return {name: dict(c) for name, c in COUNTERS.items()}


def reset_spectral_counts() -> None:
    for c in COUNTERS.values():
        c.clear()


def _ns_orthonormalize(Q: torch.Tensor, steps: int = 3) -> torch.Tensor:
    """Newton-Schulz polar iteration Q <- Q (3I - Q^T Q) / 2."""
    eye = torch.eye(Q.shape[-1], dtype=Q.dtype, device=Q.device)
    for _ in range(steps):
        G = Q.transpose(-1, -2) @ Q
        Q = Q @ (1.5 * eye - 0.5 * G)
    return Q


def jacobi_generator(B: torch.Tensor) -> torch.Tensor:
    """The skew rotation generator S of one sweep over the Rayleigh-Ritz
    matrix ``B``: the exact 2x2 Jacobi tangents, Frobenius-capped at
    `_MAX_S_NORM`."""
    d = B.diagonal(dim1=-2, dim2=-1)
    E = B - torch.diag_embed(d)
    diff = d[..., None, :] - d[..., :, None]  # d_j - d_i at (i, j)
    sgn = torch.where(diff >= 0, 1.0, -1.0).to(B.dtype)
    denom = diff.abs() + torch.sqrt(diff * diff + 4.0 * E * E)
    t = torch.where(denom > 0, 2.0 * E * sgn / torch.clamp(denom, min=1e-30),
                    torch.zeros_like(E))
    # S must be exactly skew: at ties diff == 0 gives sgn = +1 at both
    # (i, j) and (j, i); take the upper triangle and antisymmetrize
    t = torch.triu(t, 1)
    t = t - t.transpose(-1, -2)
    s_norm = torch.sqrt((t * t).sum((-2, -1)))
    return t * torch.clamp(_MAX_S_NORM / torch.clamp(s_norm, min=1e-30), max=1.0)[..., None, None]


def off_diagonal_residual(B: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(diag(B), ||B - diag(B)||_F / ||B||_F)``."""
    w = B.diagonal(dim1=-2, dim2=-1)
    off = B - torch.diag_embed(w)
    return w, torch.sqrt((off * off).sum((-2, -1))) / torch.clamp(
        torch.sqrt((B * B).sum((-2, -1))), min=1e-30)


def jacobi_refine(K: torch.Tensor, V: torch.Tensor,
                  sweeps: int = 1) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Refine an approximate eigenbasis ``V`` of symmetric ``K``; returns
    ``(w, V', res)`` with ``K ~= V' diag(w) V'^T`` and ``res`` the relative
    off-diagonal residual after the last sweep (``(*batch)``)."""
    REFINEMENTS[K.shape[-1]] += 1
    B = (V.transpose(-1, -2) @ K) @ V
    eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    for _ in range(sweeps):
        Q = _ns_orthonormalize(eye + jacobi_generator(B))
        B = (Q.transpose(-1, -2) @ B) @ Q
        V = V @ Q
    w, res = off_diagonal_residual(B)
    return w, V, res


def _refresh(K):
    REFRESHES[K.shape[-1]] += 1
    w, V = eigh_pairs(K)
    return w, V, torch.zeros(K.shape[:-2], dtype=K.dtype, device=K.device)


def tracked_eigh(K: torch.Tensor, V_prev: torch.Tensor, step: int, refresh_every: int = 64,
                 sweeps: int = 1) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full ``eigh`` (`kron.eigh_pairs`) on every ``refresh_every``-th step,
    step 0 included (it bootstraps an identity ``V_prev``); `jacobi_refine`
    of ``V_prev`` otherwise.  ``step`` is the trainer's Python int step.
    Returns ``(w, V, res)``, ``res`` 0 on refresh steps."""
    if int(step) % refresh_every == 0:
        return _refresh(K)
    return jacobi_refine(K, V_prev, sweeps=sweeps)


def tracked_eigh_adaptive(K: torch.Tensor, V_prev: torch.Tensor, last_res: torch.Tensor,
                          step: int, max_gap: int = 128, res_threshold: float = 0.05,
                          sweeps: int = 1) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Residual-gated refresh: a full ``eigh`` when the previous step's
    residual ``last_res`` exceeded ``res_threshold``, on every
    ``max_gap``-th step, and at step 0.  Unbatched training only: the gate
    reads ``last_res`` on the host, which syncs with the device every step
    (the JAX package keeps it in a ``lax.cond``)."""
    if last_res.numel() != 1:
        raise ValueError("tracked_eigh_adaptive: unbatched only (one last_res)")
    if int(step) % max_gap == 0 or float(last_res) > res_threshold:
        return _refresh(K)
    return jacobi_refine(K, V_prev, sweeps=sweeps)
