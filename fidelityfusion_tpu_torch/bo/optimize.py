"""Acquisition maximization: multi-start Adam and random-candidate argmax.

Port of `fidelityfusion_tpu/bo/optimize.py`.  The JAX package's
`lax.scan` over a vmapped start batch becomes a Python loop over Adam
steps on a ``(raw_samples, d)`` tensor: each step ascends the summed
acquisition (so every start follows its own gradient), then clips the
starts to the box; the winner is the per-start argmax of the final values.

Adam is optax's (b1 0.9, b2 0.999, eps 1e-8 outside the square root,
bias-corrected moments), without the trainer's NaN rollback or frozen
leaves (`train/fit.py`).  Starts and candidates are uniform draws from a
CPU ``torch.Generator`` moved to ``device``, or given (``x0``,
``candidates``: the JAX package's draws in the tests).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from fidelityfusion_tpu_torch.utils.device import resolve_device

B1, B2, EPS = 0.9, 0.999, 1e-8


def box(bounds, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo (d,), hi (d,)) float32 tensors of a ``(d, 2)`` box."""
    b = torch.as_tensor(np.asarray(bounds, np.float32), device=device)
    return b[:, 0], b[:, 1]


def uniform(generator: Optional[torch.Generator], shape, lo, hi) -> torch.Tensor:
    """Uniform draws in the box [lo, hi) of ``shape`` (last axis d), drawn
    on the CPU from ``generator`` (seeded 0 if None) and moved to lo's
    device."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    u = torch.rand(tuple(shape), generator=generator).to(lo.device)
    return u * (hi - lo) + lo


def _ascend(score, x0: torch.Tensor, lo, hi, steps: int, lr: float):
    """``steps`` Adam steps of every start in ``x0`` up ``score`` (a batch
    (n, d) -> (n,)), clipped to [lo, hi] after each; returns the best start
    and its value."""
    x = x0.detach().clone()
    mu, nu = torch.zeros_like(x), torch.zeros_like(x)
    for t in range(1, steps + 1):
        xg = x.requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(-score(xg).sum(), xg)
        x = xg.detach()
        mu = B1 * mu + (1 - B1) * g
        nu = B2 * nu + (1 - B2) * g * g
        upd = (mu / (1 - B1 ** t)) / (torch.sqrt(nu / (1 - B2 ** t)) + EPS)
        x = torch.minimum(torch.maximum(x - lr * upd, lo), hi)
    with torch.no_grad():
        vals = score(x).reshape(-1)
    best = int(torch.argmax(vals))
    return x[best], vals[best]


def optimize_acqf(acq_fn: Callable[..., torch.Tensor], bounds,
                  generator: Optional[torch.Generator] = None, raw_samples: int = 30,
                  steps: int = 30, lr: float = 0.1, acq_args: Optional[tuple] = None,
                  x0: Optional[torch.Tensor] = None, device="cuda"):
    """Maximize ``acq_fn`` (batch (n, d) -> (n,)) over the box ``bounds``
    ((d, 2) of [lo, hi]); returns (best_x (d,), best_value).

    ``raw_samples`` uniform starts (from ``generator``, or ``x0``) ascend
    together; the winner is the best final value.  With ``acq_args`` the
    score is called ``acq_fn(x, *acq_args)`` (the JAX package's call form,
    kept; there is no compiled program to cache here)."""
    device = resolve_device(device)
    lo, hi = box(bounds, device)
    if x0 is None:
        x0 = uniform(generator, (raw_samples, lo.shape[0]), lo, hi)
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=device)
    args = tuple(acq_args) if acq_args is not None else ()
    return _ascend(lambda x: acq_fn(x, *args), x0, lo, hi, int(steps), float(lr))


def find_next_batch(acq_fn: Callable[[torch.Tensor], torch.Tensor], bounds,
                    generator: Optional[torch.Generator] = None, batch_size: int = 1,
                    n_samples: int = 1000, candidates: Optional[torch.Tensor] = None,
                    device="cuda") -> torch.Tensor:
    """Random-candidate argmax: ``n_samples`` uniform points per batch slot
    (``candidates`` ``(batch_size, n_samples, d)`` if given), the
    acquisition argmax of each; returns ``(batch_size, d)``."""
    device = resolve_device(device)
    lo, hi = box(bounds, device)
    if candidates is None:
        candidates = uniform(generator, (batch_size, n_samples, lo.shape[0]), lo, hi)
    candidates = torch.as_tensor(candidates, dtype=torch.float32, device=device)
    with torch.no_grad():
        return torch.stack([xs[torch.argmax(acq_fn(xs).reshape(-1))] for xs in candidates])
