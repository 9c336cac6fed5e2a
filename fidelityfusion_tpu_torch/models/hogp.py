"""HOGP: high-order GP for tensor-valued outputs via Kronecker structure.

Port of `fidelityfusion_tpu/models/hogp.py`.  The covariance over
``vec(Y)`` is ``K_0(x, x) (x) K_1 (x) ... (x) K_M``, ``K_m`` the Grams over
per-output-mode integer grids, all with one shared kernel; the NLML runs
through per-mode eigendecompositions (`ops/kron.py`) and never forms the
Kronecker matrix.  ``noise = 1 / noise_variance``.  `nll_with_state`
returns an explicit `HOGPState` that `predict` consumes; `predict` gives
the exact posterior diagonal in the shared eigenbasis.  The Grams of the
NLML are built and decomposed in float64 (`_grams`, `ops/kron.py`); the
rest of the NLML, its backward and `predict` run in the targets' float32.

Parameter leaves may carry a leading restart dimension R (the trainer's
restart batch); the targets are then ``(n, d_1..d_M)`` shared or ``(R, n,
d_1..d_M)``.  Every Gram (``K_0`` with its jitter and ``y_var`` in one
pass, the mode Grams, the cross-Gram of `predict`) is K1
(`ops/gram.py`); a dim-1 length scale broadcasts over the inputs there.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from fidelityfusion_tpu_torch.ops import kron, linalg
from fidelityfusion_tpu_torch.ops.kernels import Kernel
from fidelityfusion_tpu_torch.utils.device import resolve_device
from fidelityfusion_tpu_torch.utils.tree import tree_leaves, tree_map

JITTER = linalg.JITTER


@functools.lru_cache(maxsize=None)
def _constant(value: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A 0-dim ``value`` made once per (value, dtype, device) and never
    written: a tensor from a Python number on the card is a host-to-device
    copy, which syncs the stream and cannot be captured in a CUDA graph."""
    return torch.tensor(value, dtype=dtype, device=device)


class HOGPState(NamedTuple):
    """Posterior cache of the NLML pass."""

    K_modes: tuple  # mode Grams K_1..K_M (d_m, d_m)
    eigvecs: tuple  # V_0..V_M
    eigvals: tuple  # lambda_0..lambda_M (clamped at 0)
    A: torch.Tensor  # eigenvalue tensor + noise, (n, d_1..d_M)
    g: torch.Tensor  # Sigma^-1 y as a tensor


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device


@dataclasses.dataclass(frozen=True)
class HOGP:
    """Static spec of the high-order GP.  ``learnable_grid`` /
    ``learnable_map`` make the per-mode grid coordinates and a per-mode map
    trainable (both off by default, as in the JAX package)."""

    kernel: Kernel
    output_shape: Tuple[int, ...]
    jitter: float = JITTER
    learnable_grid: bool = False
    learnable_map: bool = False

    def init_params(self, input_dim: int, noise_variance: float = 1.0, device="cuda"):
        del input_dim  # the mode kernels share params; a dim-1 ls broadcasts
        device = resolve_device(device)
        p = {
            "kernel": self.kernel.init_params(1, device=device),
            "noise_variance": torch.tensor([noise_variance], device=device),
        }
        if self.learnable_grid:
            p["grids"] = [torch.arange(d, dtype=torch.float32, device=device).reshape(-1, 1)
                          for d in self.output_shape]
        if self.learnable_map:
            p["maps"] = [torch.eye(d, device=device) for d in self.output_shape]
        return p

    def grids(self, params=None) -> List[torch.Tensor]:
        """Per-mode grid coordinates: integer grids by default (on the
        parameters' device); the trainable (optionally map-transformed) ones
        when the learnable flags are set."""
        device = "cpu" if params is None else _device(params)
        if self.learnable_grid and params is not None and "grids" in params:
            gs = params["grids"]
        else:
            gs = [torch.arange(d, dtype=torch.float32, device=device).reshape(-1, 1)
                  for d in self.output_shape]
        if self.learnable_map and params is not None and "maps" in params:
            gs = [m @ g for m, g in zip(params["maps"], gs)]
        return gs

    def noise(self, params) -> torch.Tensor:
        return 1.0 / params["noise_variance"][..., 0]

    def _mode_gram(self, kp, g):
        if g.ndim == 2:
            return self.kernel.apply(kp, g, g)
        # a grid per restart: K1 takes inputs shared by its batch
        return torch.stack([self.kernel.apply(tree_map(lambda a, r=r: a[r], kp), g[r], g[r])
                            for r in range(g.shape[0])])

    def _grams(self, params, x_train, y_var=None):
        """K_0 (with the jitter and ``y_var``) and the mode Grams, in float64
        (see `ops/kron.py`: the Kronecker product amplifies their small
        eigenvalues past a float32 Gram's rounding)."""
        f64 = torch.float64
        kp = tree_map(lambda a: a.to(f64), params["kernel"])
        jit = _constant(self.jitter, f64, x_train.device)
        K0 = self.kernel.apply(kp, x_train.to(f64), x_train.to(f64), diag_add=jit,
                               y_var=None if y_var is None else y_var.to(f64))
        return K0, [self._mode_gram(kp, g.to(f64)) for g in self.grids(params)]

    def nll_with_state(self, params, x_train, y_train,
                       y_var: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, HOGPState]:
        """Per-element-normalized NLML and the posterior state (``y_train``
        ``(n, d_1..d_M)``; ``y_var`` a per-sample noise vector on K_0's
        diagonal).  Differentiable through ``eigh``; training uses `nll`."""
        K0, K_modes = self._grams(params, x_train, y_var)
        Ks = [K0] + K_modes
        Kb, yb, nb = kron._batched(Ks, y_train, self.noise(params))
        pairs = [kron.to_targets(kron.eigh_pairs(K), y_train) for K in Kb]
        eigvecs = [p[1] for p in pairs]
        loss, eigvals, A, T1 = kron._loss_and_saved([p[0] for p in pairs], eigvecs, yb, nb)
        g = kron.multi_mode_dot(T1 / A, eigvecs, modes=range(1, len(Ks) + 1))
        batched = y_train.ndim == len(Ks) + 1 or any(K.ndim == 3 for K in Ks)
        sq = (lambda t: t) if batched else (lambda t: t[0])  # noqa: E731
        state = HOGPState(K_modes=kron.to_targets(K_modes, y_train),
                          eigvecs=tuple(sq(V) for V in eigvecs),
                          eigvals=tuple(sq(w) for w in eigvals), A=sq(A), g=sq(g))
        return sq(loss), state

    def nll(self, params, x_train, y_train, y_var=None) -> torch.Tensor:
        """Training NLML: `nll_with_state`'s value through `kron.kron_nlml`,
        whose backward reuses the forward's eigenpairs."""
        K0, K_modes = self._grams(params, x_train, y_var)
        return kron.kron_nlml([K0] + K_modes, y_train, self.noise(params))

    def tracking_aux0(self, n: int, device="cuda"):
        """Initial aux of `nll_tracked`: ``(V0, max_res)``, V0 the identity
        (step 0 always refreshes, so its content never matters)."""
        device = resolve_device(device)
        return (torch.eye(n, device=device), torch.zeros((), device=device))

    def nll_tracked(self, params, aux, step, x_train, y_train, y_var=None,
                    refresh_every: int = 64, sweeps: int = 1):
        """`nll` with mode 0's eigenbasis tracked across steps
        (`kron.tracked_kron_nlml`): a full ``eigh`` every ``refresh_every``
        steps, Jacobi sweeps in between.  ``aux = (V_prev, max_res)``
        (`tracking_aux0`, broadcast over restarts), ``step`` the trainer's
        int step (`train.fit.adam_scan_aux`).  Returns ``(loss, new_aux)``."""
        V_prev, max_res = aux
        K0, K_modes = self._grams(params, x_train, y_var)
        loss, V_new, res = kron.tracked_kron_nlml(refresh_every, sweeps)(
            [K0] + K_modes, y_train, self.noise(params), V_prev, step)
        return loss, (V_new, torch.maximum(max_res, res))

    def tracking_aux0_adaptive(self, n: int, device="cuda"):
        """Initial aux of `nll_tracked_adaptive`: ``(V0, max_res, last_res)``."""
        device = resolve_device(device)
        zero = torch.zeros((), device=device)
        return (torch.eye(n, device=device), zero, zero.clone())

    def nll_tracked_adaptive(self, params, aux, step, x_train, y_train, y_var=None,
                             max_gap: int = 128, res_threshold: float = 0.05, sweeps: int = 1):
        """`nll_tracked` with the residual-gated refresh
        (`kron.tracked_kron_nlml_adaptive`).  Unbatched training only: the
        gate reads the previous residual on the host, one device sync a
        step.  ``aux = (V_prev, max_res, last_res)``."""
        V_prev, max_res, last_res = aux
        K0, K_modes = self._grams(params, x_train, y_var)
        loss, V_new, res = kron.tracked_kron_nlml_adaptive(max_gap, res_threshold, sweeps)(
            [K0] + K_modes, y_train, self.noise(params), V_prev, last_res, step)
        return loss, (V_new, torch.maximum(max_res, res), res)

    def predict(self, params, state: HOGPState, x_train,
                x_test) -> Tuple[torch.Tensor, torch.Tensor]:
        """Posterior mean and diagonal variance, ``(m, d_1..d_M)`` each: the
        mean by mode products with the cached ``g``, the variance the exact
        posterior diagonal in the shared eigenbasis, plus the noise."""
        kp = params["kernel"]
        K_star = self.kernel.apply(kp, x_test, x_train)  # (m, n)
        mean = kron.multi_mode_dot(state.g, [K_star] + list(state.K_modes))
        prior_diag = kron.rank1_tucker([self.kernel.diag(kp, x_test)]
                                       + [Km.diagonal() for Km in state.K_modes])
        P0 = (K_star @ state.eigvecs[0]) ** 2
        P_modes = [(Km @ V) ** 2 for Km, V in zip(state.K_modes, state.eigvecs[1:])]
        explained = kron.multi_mode_dot(1.0 / state.A, [P0] + P_modes)
        var = torch.clamp(prior_diag - explained, min=1e-12) + self.noise(params)
        return mean, var
