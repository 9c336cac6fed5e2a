"""Hyperparameter training: Adam with the NaN last-good rollback, restarts.

Port of `fidelityfusion_tpu/train/fit.py` (`adam_scan`, `adam_scan_aux`,
`_frozen_mask`, `fit`, `fit_restarts`, `fit_restarts_tracked_adaptive`,
`gp_restart_batch`, `LADDER_FACTORS`, `stack_params`, `perturb_params`).
The JAX `lax.scan` becomes a Python
loop that keeps every value on the device (no host sync per step), and
`vmap` over restarts becomes a leading batch dimension R on every
parameter leaf: the loss returns one value per restart, and the rollback
decides per restart.  A loss that names the host branch of each step
(``graph_key(step)``) trains over one set of buffers, and on the card
replays each branch's step from one CUDA graph (`_replayed_steps`).

Adam is written out to match `optax.adam(lr)`: b1 0.9, b2 0.999, eps 1e-8,
bias-corrected moments, update ``-lr * mu_hat / (sqrt(nu_hat) + eps)``.
"""

from __future__ import annotations

import contextlib
import math
from collections import Counter
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fidelityfusion_tpu_torch.ops import cuda, spectral
from fidelityfusion_tpu_torch.ops.kernels import median_heuristic, trainable_mask
from fidelityfusion_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

B1, B2, EPS = 0.9, 0.999, 1e-8
LADDER_FACTORS = (1.0, 0.5, 0.25, 0.125, 0.0625, 2.0, 4.0)


class FitResult(NamedTuple):
    params: dict
    losses: torch.Tensor  # (*batch, steps)


def _frozen_mask(params) -> dict:
    """True for trainable leaves; leaves under keys starting with "_" are
    frozen constants."""
    return trainable_mask(None, params)


def _bcast(flag, leaf):
    """A (*batch) tensor shaped to broadcast against a (*batch, ...) leaf."""
    return flag.reshape(flag.shape + (1,) * (leaf.ndim - flag.ndim))


def _adam_update(carry, loss, grads, new_aux, flags, lr):
    """Adam's update of ``carry = (p, opt, good_p, good_opt, aux)`` from one
    step's ``loss`` (``(*batch)``), gradients (None for frozen or unused
    leaves) and ``new_aux``, with the NaN last-good rollback decided per
    restart on the device.  Returns the next carry."""
    p, opt, good_p, good_opt, aux = carry
    grads = iter(grads)
    mu, nu, count = opt
    if count is None:  # the batch shape is the loss's
        count = torch.zeros_like(loss)
        opt = good_opt = (mu, nu, count)
    count_n = count + 1
    one = torch.ones((), dtype=loss.dtype, device=loss.device)
    bc1 = 1 - torch.pow(one * B1, count_n)
    bc2 = 1 - torch.pow(one * B2, count_n)
    finite = torch.isfinite(loss)
    new_p, new_mu, new_nu = [], [], []
    for x, m, v, f in zip(p, mu, nu, flags):
        g = next(grads) if f else None
        if g is None:
            g = torch.zeros_like(x)
        m = (1 - B1) * g + B1 * m
        v = (1 - B2) * g ** 2 + B2 * v
        upd = (m / _bcast(bc1, m)) / (torch.sqrt(v / _bcast(bc2, v)) + EPS) * (-lr)
        finite = finite & torch.isfinite(upd).reshape(loss.shape + (-1,)).all(-1)
        new_p.append(x + upd)
        new_mu.append(m)
        new_nu.append(v)

    def sel(new, old):
        return [torch.where(_bcast(finite, a), a, b) for a, b in zip(new, old)]

    def sel_opt(new, old):
        return (sel(new[0], old[0]), sel(new[1], old[1]),
                torch.where(finite, new[2], old[2]))

    p, good_p, opt, good_opt = (
        sel(new_p, good_p), sel(p, good_p),
        sel_opt((new_mu, new_nu, count_n), good_opt), sel_opt(opt, good_opt),
    )
    if aux is not None:
        aux = sel(new_aux, aux)
    return p, opt, good_p, good_opt, aux


def _adam_loop(loss_fn, p0, aux0, lr, steps, trainable, loss_args, opt_state0, step0):
    """The Adam loop behind `adam_scan` and `adam_scan_aux`; with ``aux0``
    None the loss is ``loss_fn(p, *loss_args)``, else ``loss_fn(p, aux,
    step, *loss_args) -> (loss, new_aux)``.  Returns the final carry
    ``(p, opt, good_p, good_opt, aux)`` (leaves as lists, the optimizer
    state ``(mu, nu, count)``) and the losses ``(*batch, steps)``.

    A loss with a ``graph_key(step)`` method trains through
    `_replayed_steps` (CUDA graphs on the card); any other loss step by
    step here."""
    flags = (tree_leaves(trainable) if trainable is not None
             else [True] * len(tree_leaves(p0)))
    p = [x.detach() for x in tree_leaves(p0)]
    if opt_state0 is None:
        opt_state0 = ([torch.zeros_like(x) for x in p], [torch.zeros_like(x) for x in p], None)
    carry = (p, opt_state0, p, opt_state0, None if aux0 is None else tree_leaves(aux0))

    def step_fn(carry, step):
        ps = [x.detach().requires_grad_(bool(f)) for x, f in zip(carry[0], flags)]
        new_aux = None
        with torch.enable_grad():
            if aux0 is None:
                loss = loss_fn(tree_unflatten(p0, ps), *loss_args)
            else:
                loss, new_aux = loss_fn(tree_unflatten(p0, ps), tree_unflatten(aux0, carry[4]),
                                        step, *loss_args)
                new_aux = [a.detach() for a in tree_leaves(new_aux)]
            live = [x for x, f in zip(ps, flags) if f]
            grads = torch.autograd.grad(loss.sum(), live, allow_unused=True)
        loss = loss.detach()
        return _adam_update(carry, loss, grads, new_aux, flags, lr), loss

    graph_key = getattr(loss_fn, "graph_key", None)
    if graph_key is None:
        history = []
        for i in range(steps):
            carry, loss = step_fn(carry, step0 + i)
            history.append(loss)
    else:
        carry, history = _replayed_steps(step_fn, carry,
                                         step_calendar(graph_key, step0, steps, p[0].is_cuda))
    losses = torch.stack(history, dim=-1) if history else torch.zeros(0)
    return carry, losses


# Training steps of losses with a ``graph_key`` since the last
# `reset_graph_counts`, by what `_replayed_steps` did with them.
GRAPH_COUNTS: Counter = Counter()


def graph_counts() -> Dict[str, int]:
    """``{"captured": ..., "replayed": ..., "eager": ...}``: the training
    steps of losses with a ``graph_key`` since the last
    `reset_graph_counts`: captured into a CUDA graph (a captured step also
    counts once as replayed, since capture runs nothing), replayed from
    one, and run eagerly (refreshes, warm-ups, every step off the card).
    Plain host integers, as `ops/cuda.py:launch_counts`; steps of other
    losses are not counted."""
    return {k: GRAPH_COUNTS[k] for k in ("captured", "replayed", "eager")}


def reset_graph_counts() -> None:
    GRAPH_COUNTS.clear()


def step_calendar(graph_key, step0: int, steps: int,
                  on_card: bool) -> List[Tuple[int, str, object]]:
    """``(step, action, key)`` for each step of a loss with ``graph_key``:
    "eager" where the key is None, and for every step off the card; on the
    card, "warm-up" for a key's first step (eager, on a side stream),
    "capture" for its second and "replay" after that."""
    out, seen = [], Counter()
    for step in range(step0, step0 + steps):
        key = graph_key(step) if on_card else None
        if key is None:
            out.append((step, "eager", None))
            continue
        seen[key] += 1
        out.append((step, ("warm-up", "capture", "replay")[min(seen[key], 3) - 1], key))
    return out


def _host_counts() -> Counter:
    """Every host counter a training step can bump: the kernel wrappers'
    launches (`ops/cuda.py`) and the spectral layer's calls by n
    (`ops/spectral.py`)."""
    counts = Counter({("launches", k): v for k, v in cuda.launch_counts().items()})
    for table, by_n in spectral.spectral_counts().items():
        counts.update({(table, n): v for n, v in by_n.items()})
    return counts


def _add_counts(delta: Counter, sign: int = 1) -> None:
    for (table, key), d in delta.items():
        if table == "launches":
            cuda.counter(key).launches += sign * d
        else:
            spectral.COUNTERS[table][key] += sign * d


def _buffers(carry):
    """The first step's carry as the buffers of every later step, each
    C-contiguous: the layout a Jacobi step's tensors take (a refresh gives
    the eigenvectors in ``eigh``'s column-major order, and every replayed
    step would then read its basis through the transposed GEMMs)."""
    return tree_map(lambda t: None if t is None else t.contiguous(), carry)


def _write(dst, src) -> None:
    """Copy each tensor leaf of ``src`` into ``dst``'s, in place."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        if d is not None:
            d.copy_(s)


def _capture(step_fn, carry, step):
    """One step over ``carry``'s tensors, captured into a CUDA graph that
    writes the next carry back into them.  Returns ``(graph, loss,
    counts)``: the step's loss tensor, which every replay overwrites, and
    the host counts the step bumps, which every replay adds (capture runs
    nothing, so they are taken back here).  The step must not sync with
    the host nor copy from pageable memory: capture refuses both."""
    before = _host_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=_side_stream(torch.cuda.current_stream().device)):
        new, loss = step_fn(carry, step)
        _write(carry, new)
    counts = _host_counts() - before
    _add_counts(counts, -1)
    return graph, loss, counts


def _replayed_steps(step_fn, carry, calendar):
    """The steps of a loss with a ``graph_key`` (`step_calendar`), over one
    set of buffers: every step writes its carry into the tensors of the
    first step's, in place.  A step whose key is None runs eagerly; on the
    card, a key's first step runs eagerly on a side stream (the warm-up
    ``torch.cuda.graph`` asks for), its second is captured into a CUDA
    graph on that stream, and every later one replays it: one graph launch
    for the step's ~500 kernels, its host-side Python not run again.  So a
    key's steps must launch the same work on the same buffers whatever the
    step.  The graphs and their memory pools live for this call only.
    Returns ``(carry, losses)``, each step's loss copied out of the
    graph's."""
    graphs, history = {}, []
    for step, action, key in calendar:
        if action == "capture":
            graphs[key] = _capture(step_fn, carry, step)
            GRAPH_COUNTS["captured"] += 1
        if action in ("capture", "replay"):
            graph, loss, counts = graphs[key]
            graph.replay()
            _add_counts(counts)
            history.append(loss.clone())
            GRAPH_COUNTS["replayed"] += 1
            continue
        main = torch.cuda.current_stream() if action == "warm-up" else None
        with _on_side_stream(main):
            new, loss = step_fn(carry, step)
            if not history:  # the first step: its fresh tensors become the buffers
                carry = _buffers(new)
            else:
                _write(carry, new)
        if main is not None:  # made on the side stream, used on the main one
            for t in [loss] + tree_leaves(carry):
                if t is not None:
                    t.record_stream(main)
        history.append(loss)
        GRAPH_COUNTS["eager"] += 1
    return carry, history


# One stream per device for the warm-ups and the captures, made at first
# use: cuBLAS keeps a workspace (32 MiB) for every (handle, stream) it has
# run on for the life of the process, so a new stream a stage would add
# one at every stage.
_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _side_stream(device) -> "torch.cuda.Stream":
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


@contextlib.contextmanager
def _on_side_stream(main):
    """Work on the side stream, after what ``main`` holds, then ``main``
    waiting for it; nothing changes where ``main`` is None."""
    if main is None:
        yield
        return
    side = _side_stream(main.device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        yield
    main.wait_stream(side)


def adam_scan(loss_fn: Callable, p0, lr: float, steps: int, trainable=None,
              loss_args=()):
    """``steps`` Adam updates of ``loss_fn(p, *loss_args)`` with the NaN
    last-good rollback: a step whose loss or update is not finite resets
    that restart's params and optimizer state to the last snapshot whose
    loss was verified finite (the JAX package's `adam_scan`).

    Returns ``(p_final, good_p, losses)``: ``p_final`` is one
    never-evaluated update ahead, ``good_p`` the last params whose loss was
    finite, ``losses`` ``(*batch, steps)``, all on the device."""
    (p, _, good_p, _, _), losses = _adam_loop(loss_fn, p0, None, lr, steps, trainable,
                                              loss_args, None, 0)
    return tree_unflatten(p0, p), tree_unflatten(p0, good_p), losses


def adam_scan_aux(loss_fn: Callable, p0, aux0, lr: float, steps: int, trainable=None,
                  loss_args=(), opt_state0=None, step0: int = 0, return_carry: bool = False):
    """`adam_scan` for a loss that threads an auxiliary carry (the HOGP
    tracked eigenbasis): ``loss_fn(p, aux, step, *loss_args) -> (loss,
    new_aux)``, ``step`` the Python int step counter (``step0`` + the step's
    index), outside the aux, so a refresh predicate on it is one host
    branch for every restart.  A non-finite step keeps the last good
    params, optimizer state and aux (the JAX package's `adam_scan_aux`).

    Segments resume with ``opt_state0`` (a previous carry's optimizer
    state) and ``step0``; ``return_carry=True`` also returns the final
    carry ``(p, opt_state, good_p, good_opt, aux)`` (parameter trees).
    Returns ``(p_final, good_p, losses, aux_final)`` (plus the carry)."""
    (p, opt, good_p, good_opt, aux), losses = _adam_loop(
        loss_fn, p0, aux0, lr, steps, trainable, loss_args, opt_state0, step0)
    p, good_p, aux = (tree_unflatten(p0, p), tree_unflatten(p0, good_p),
                      tree_unflatten(aux0, aux))
    if return_carry:
        return p, good_p, losses, aux, (p, opt, good_p, good_opt, aux)
    return p, good_p, losses, aux


def fit(loss_fn: Callable, params: dict, steps: int = 100, lr: float = 1e-2,
        trainable: Optional[dict] = None, loss_args: Optional[tuple] = None,
        aux0=None) -> FitResult:
    """Minimize ``loss_fn(params, *loss_args)`` with Adam for ``steps``
    steps; returns the last verified-finite params and the loss history.
    With ``aux0`` the loss threads an aux carry (`adam_scan_aux`)."""
    if trainable is None:
        trainable = _frozen_mask(params)
    loss_args = tuple(loss_args or ())
    if aux0 is not None:
        _, good_p, losses, _ = adam_scan_aux(loss_fn, params, aux0, lr, steps, trainable,
                                             loss_args)
    else:
        _, good_p, losses = adam_scan(loss_fn, params, lr, steps, trainable, loss_args)
    return FitResult(good_p, losses)


def restart_scores(losses) -> np.ndarray:
    """Each restart's LAST FINITE loss (+inf if none): the loss at the
    params it returns.  ``losses`` is (R, steps)."""
    L = np.asarray(losses.detach().cpu() if torch.is_tensor(losses) else losses,
                   dtype=np.float64)
    finite = np.isfinite(L)
    t_idx = np.arange(L.shape[1])
    last = np.max(np.where(finite, t_idx[None, :], -1), axis=1)
    vals = np.nan_to_num(L, nan=np.inf, posinf=np.inf, neginf=-np.inf)
    picked = np.take_along_axis(vals, np.maximum(last, 0)[:, None], axis=1)[:, 0]
    return np.where(last >= 0, picked, np.inf)


def _unbatched_loss(loss_fn, aux0):
    """The loss of one restart's params: with an aux, at step 0 (a refresh
    step, so the exact eigendecomposition) from restart 0's aux."""
    if aux0 is None:
        return loss_fn
    aux_one = tree_map(lambda a: a[0], aux0)
    return lambda p, *args: loss_fn(p, aux_one, 0, *args)[0]


def _pick_winner(params_all, losses_all, evaluate):
    """The restart with the lowest last finite loss whose loss, re-evaluated
    UNBATCHED by ``evaluate(params)``, is finite (candidates best-first, as
    in the JAX package); the argmin if none verifies."""
    score = restart_scores(losses_all)
    with torch.no_grad():
        for idx in np.argsort(score):
            if not np.isfinite(score[idx]):
                break
            cand = tree_map(lambda a, i=int(idx): a[i], params_all)
            if np.isfinite(float(evaluate(cand))):
                return cand
    best = int(np.argmin(score))
    return tree_map(lambda a: a[best], params_all)


def fit_restarts(loss_fn: Callable, params_batch: dict, steps: int = 100,
                 lr: float = 1e-2, trainable: Optional[dict] = None,
                 loss_args: Optional[tuple] = None, aux0=None):
    """Train every restart of ``params_batch`` (leading axis R) at once and
    pick the restart with the lowest last finite loss.

    The winner is re-verified UNBATCHED (the single-matrix kernel, K2):
    candidates are walked best-first until one gives a finite loss, as in
    the JAX package.  ``aux0`` (leading axis R) threads an aux carry
    (`adam_scan_aux`); the re-verification then runs at step 0, a refresh.
    Returns ``(best_params, FitResult(all_params, all_losses))`` with
    ``all_losses`` (R, steps)."""
    if trainable is None:
        trainable = _frozen_mask(params_batch)
    loss_args = tuple(loss_args or ())
    if aux0 is not None:
        _, params_all, losses_all, _ = adam_scan_aux(loss_fn, params_batch, aux0, lr, steps,
                                                     trainable, loss_args)
    else:
        _, params_all, losses_all = adam_scan(loss_fn, params_batch, lr, steps,
                                              trainable, loss_args)
    evaluate = _unbatched_loss(loss_fn, aux0)
    best = _pick_winner(params_all, losses_all, lambda p: evaluate(p, *loss_args))
    return best, FitResult(params_all, losses_all)


def fit_restarts_tracked_adaptive(loss_fn, params_batch, aux0_batch, steps: int = 128,
                                  lr: float = 1e-2, segment: int = 16,
                                  res_threshold: float = 0.1, trainable: Optional[dict] = None,
                                  loss_args: Optional[tuple] = None):
    """Batched residual-gated refresh: the restarts train in segments of
    ``segment`` steps, and between segments the batch-max tracking residual
    of the last segment decides, on the host, whether the next segment
    starts with one full ``eigh`` for every restart (its step counter starts
    at 0) or not (at 1).  ``loss_fn`` must be built with ``refresh_every`` >
    ``segment`` (e.g. ``_Gar0LossTracked(hogp, refresh_every=1 << 20)``), so
    only a segment's step 0 refreshes; segment 0 always does.  Params and
    Adam state resume across segments, so the trajectory is that of one
    long run with refreshes at the chosen boundaries.

    ``aux0_batch`` is the tracking aux ``(V, max_res)`` with a leading
    restart axis; ``max_res`` is reset at every boundary.  Returns
    ``(best_params, FitResult(all_params, all_losses), refresh_segments)``."""
    if trainable is None:
        trainable = _frozen_mask(params_batch)
    loss_args = tuple(loss_args or ())
    n_seg = max(1, math.ceil(steps / segment))
    p, opt, aux = params_batch, None, aux0_batch
    chunks, refreshed, need_refresh = [], [], True
    for s in range(n_seg):
        if need_refresh:
            refreshed.append(s)
        seg_steps = min(segment, steps - s * segment)
        _, _, losses, aux, carry = adam_scan_aux(
            loss_fn, p, aux, lr, seg_steps, trainable, loss_args, opt_state0=opt,
            step0=0 if need_refresh else 1, return_carry=True)
        p, opt, params_all = carry[0], carry[1], carry[2]
        chunks.append(losses)
        need_refresh = float(aux[1].max()) > res_threshold
        aux = (aux[0], torch.zeros_like(aux[1]))
    losses_all = torch.cat(chunks, dim=1)
    evaluate = _unbatched_loss(loss_fn, aux0_batch)
    best = _pick_winner(params_all, losses_all, lambda q: evaluate(q, *loss_args))
    return best, FitResult(params_all, losses_all), refreshed


def gp_restart_batch(kernel_spec, gp_params: dict, x, n: int,
                     generator: Optional[torch.Generator] = None):
    """``n`` restart initializations of one GP's parameter dict: restart 0
    is ``gp_params``; restart i >= 1 sets the length scales to
    ``LADDER_FACTORS[i-1] * median_heuristic(x)`` and a low noise (a CIGP's
    ``log_beta = 2``, a GPBasic's ``noise_variance = 0.3``): a deterministic
    ladder; restarts past the ladder are random jitter from ``generator``."""
    med = median_heuristic(x)
    out = [gp_params]
    for i in range(1, n):
        if i - 1 < len(LADDER_FACTORS):
            p = dict(gp_params)
            p["kernel"] = kernel_spec.set_lengthscales(
                gp_params["kernel"], med * LADDER_FACTORS[i - 1])
            for key, low in (("log_beta", 2.0), ("noise_variance", 0.3)):
                if key in p:
                    p[key] = torch.tensor([low], device=p[key].device)
            out.append(p)
        else:
            jittered = perturb_params(generator, gp_params, scale=1.0, n=2)
            out.append(tree_map(lambda a: a[1], jittered))
    return out


def stack_params(params_list):
    """Stack same-structure trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), params_list[0], *params_list[1:])


def perturb_params(generator: Optional[torch.Generator], params: dict,
                   scale: float = 1.0, n: int = 1):
    """``n`` copies of ``params`` stacked on a new leading axis, copies 1..n-1
    with N(0, scale^2) noise from ``generator`` (copy 0 is unperturbed)."""

    def noisy(a):
        noise = torch.randn(a.shape, generator=generator, dtype=a.dtype)
        return a + scale * noise.to(a.device)

    copies = [params] + [tree_map(noisy, params) for _ in range(1, n)]
    return stack_params(copies)
