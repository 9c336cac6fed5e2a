"""Faults planted under the timed path, to show that a cell's comparison
fails: each is a context manager that patches the port's functions in
this process and restores them.  The CPU tests plant them at tiny sizes;
`control.py --fault` reads them on the card at a cell's own size.

    frozen_steps    every Adam step of the trainer returns its state unchanged
    half_rows       the NLML over half the training rows, the mean over them
    half_queries    a posterior query answered for its first half of points
    altered_answer  the posterior's answer (mean and variance) shifted by 1
                    where produced
"""

from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def _patched(*triples):
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in triples]
    try:
        for obj, name, value in triples:
            setattr(obj, name, value)
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def frozen_steps():
    from fidelityfusion_tpu_torch.train import fit

    orig = fit._adam_loop

    def loop(loss_fn, p0, aux0, lr, *rest):
        return orig(loss_fn, p0, aux0, 0.0, *rest)

    return _patched((fit, "_adam_loop", loop))


def half_rows():
    from fidelityfusion_tpu_torch.models.cigp import CIGP

    cigp_nll = CIGP.nll

    def cigp(self, params, x, y, y_var=None, mask=None):
        h = x.shape[0] // 2
        yv = None if y_var is None else y_var[..., :h]
        yh = y[..., :h, :] if y.ndim > 1 else y[:h]
        return 2 * cigp_nll(self, params, x[:h], yh, yv, None if mask is None else mask[:h])

    return _patched((CIGP, "nll", cigp))


def half_queries():
    from fidelityfusion_tpu_torch.models.ar import ARPosterior

    orig = ARPosterior.__call__

    def call(self, state, x):
        x = np.asarray(x)
        h = max(1, len(x) // 2)
        m, v = orig(self, state, x[:h])
        reps = -(-len(x) // h)
        return m.repeat(reps, 1)[: len(x)], v.repeat(reps)[: len(x)]

    return _patched((ARPosterior, "__call__", call))


def altered_answer():
    from fidelityfusion_tpu_torch.models.ar import ARPosterior

    post = ARPosterior.__call__

    def shifted(s, st, x):
        mean, var = post(s, st, x)
        return mean + 1.0, var + 1.0

    return _patched((ARPosterior, "__call__", shifted))


FAULTS = {"frozen_steps": frozen_steps, "half_rows": half_rows, "half_queries": half_queries,
          "altered_answer": altered_answer}
