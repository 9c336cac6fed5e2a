"""CUDA-graph replay of the restart trainer's steps (`train/fit.py:
_replayed_steps`) for losses that name their host branch (`graph_key`,
GAR's tracked losses in `models/gar.py`).

On the CPU nothing is captured: the tests there hold the calendar of
eager, warm-up, captured and replayed steps, the counters, and the
in-place step over one set of buffers against the same loss without its
key.  The tests marked ``cuda`` hold graphed fits against eager ones on
the card (skipped where there is no CUDA device, decided inside the
fixture):

    python -m pytest tests/test_torch_graph_steps.py -q -m cuda --noconftest
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

from fidelityfusion_tpu_torch.models import gar, hogp as hogp_mod
from fidelityfusion_tpu_torch.models.gar import _Gar0LossTracked, _GarResLossTracked
from fidelityfusion_tpu_torch.models.hogp import HOGP
from fidelityfusion_tpu_torch.ops import cuda, kron, spectral
from fidelityfusion_tpu_torch.ops.kernels import ARDKernel
from fidelityfusion_tpu_torch.train import fit
from fidelityfusion_tpu_torch.utils.tree import tree_leaves, tree_map


class _Keyless:
    """The same loss without its ``graph_key``: the trainer's step-by-step
    path."""

    def __init__(self, loss):
        self.loss = loss

    def __call__(self, *args):
        return self.loss(*args)


@dataclasses.dataclass(frozen=True)
class _Poisoned(_Gar0LossTracked):
    """`_Gar0LossTracked` whose loss is NaN for the restarts in ``mask`` at
    its ``at``-th call, counted on the device (``calls``), so the NaN comes
    at the same step whether the step runs eagerly or from a graph."""

    calls: torch.Tensor = None
    at: int = 0
    mask: torch.Tensor = None

    def __call__(self, p, aux, step, x, y):
        loss, new_aux = super().__call__(p, aux, step, x, y)
        self.calls.add_(1)
        hit = (self.calls == self.at) & self.mask
        return torch.where(hit, torch.full_like(loss, float("nan")), loss), new_aux


def _calendar(refresh_every, step0, steps, on_card=True):
    return fit.step_calendar(_Gar0LossTracked(HOGP(ARDKernel(), (8, 8)), refresh_every).graph_key,
                             step0, steps, on_card)


def _actions(cal, action):
    return [s for s, a, _ in cal if a == action]


def _problem(device, n=24, shape=(4, 4), restarts=3, seed=0):
    """A stage-0 HOGP problem: inputs (n, 2), smooth fields, ``restarts``
    perturbed initializations and the tracking aux broadcast over them."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((n, 2), generator=g, dtype=torch.float32)
    grids = [torch.linspace(0, 1, d) for d in shape]
    y = (torch.sin(3 * x[:, 0, None, None] + 2 * grids[0][None, :, None])
         * torch.cos(2 * x[:, 1, None, None] - grids[1][None, None, :]))
    y = y + 0.05 * torch.randn(y.shape, generator=g)
    h = HOGP(kernel=ARDKernel(), output_shape=shape)
    p = fit.perturb_params(g, {"hogp": h.init_params(2, device="cpu")}, scale=0.3, n=restarts)
    p, x, y = tree_map(lambda a: a.to(device), p), x.to(device), y.to(device)
    aux = tree_map(lambda a: a.expand((restarts,) + a.shape), h.tracking_aux0(n, device))
    return h, p, aux, x, y


def _scan(loss, p, aux, x, y, steps=12, lr=5e-2):
    """`adam_scan_aux` with the carry: ``(p, good_p, losses, aux, carry)``."""
    return fit.adam_scan_aux(loss, p, aux, lr, steps, loss_args=(x, y), return_carry=True)


def _assert_same(a, b):
    for u, v in zip(tree_leaves(a), tree_leaves(b)):
        if u is None or v is None:
            assert u is None and v is None
            continue
        torch.testing.assert_close(u, v, rtol=0, atol=0, equal_nan=True)


# ---- the calendar ----------------------------------------------------------

@pytest.mark.parametrize("refresh_every, step0, steps, eager, warm, capture", [
    (64, 0, 100, [0, 64], [1], [2]),       # a stage of the GAR cell
    (64, 0, 64, [0], [1], [2]),
    (64, 1, 100, [64], [1], [2]),
    (1 << 20, 0, 16, [0], [1], [2]),      # `fit_restarts_tracked_adaptive`'s segments
    (1 << 20, 1, 16, [], [1], [2]),
    (1 << 20, 0, 2, [0], [1], []),        # the cell's warm-up: nothing captured
    (1, 0, 5, [0, 1, 2, 3, 4], [], []),   # a refresh every step: never a key
])
def test_step_calendar(refresh_every, step0, steps, eager, warm, capture):
    cal = _calendar(refresh_every, step0, steps)
    assert [s for s, _, _ in cal] == list(range(step0, step0 + steps))
    assert _actions(cal, "eager") == eager
    assert _actions(cal, "warm-up") == warm
    assert _actions(cal, "capture") == capture
    assert _actions(cal, "replay") == sorted(
        set(range(step0, step0 + steps)) - set(eager) - set(warm) - set(capture))
    assert all((k is None) == (a == "eager") for _, a, k in cal)


def test_step_calendar_off_the_card_is_eager():
    cal = _calendar(64, 0, 100, on_card=False)
    assert _actions(cal, "eager") == list(range(100))


def test_stage_replays_at_the_cells_shape():
    """A 100-step stage at refresh_every 64: 97 steps run from its graph
    (the captured one once), 3 eagerly; the fit's three stages replay 291
    of 300."""
    cal = _calendar(64, 0, 100)
    assert len(_actions(cal, "capture")) + len(_actions(cal, "replay")) == 97


@pytest.mark.parametrize("shape, keyed", [
    ((8, 8), True), ((8, kron.SMALL_EIGH_MAX_N), True),
    ((8, kron.SMALL_EIGH_MAX_N + 1), False),  # a mode Gram through torch.linalg.eigh
])
def test_graph_key_needs_every_mode_gram_on_k5(shape, keyed):
    h = HOGP(ARDKernel(), shape)
    for loss in (_Gar0LossTracked(h), _GarResLossTracked(h, None)):
        assert loss.graph_key(0) is None
        assert (loss.graph_key(5) is not None) == keyed


# ---- the counters ----------------------------------------------------------

def test_graph_counts_and_reset():
    fit.reset_graph_counts()
    assert fit.graph_counts() == {"captured": 0, "replayed": 0, "eager": 0}
    fit.GRAPH_COUNTS["replayed"] += 3
    assert fit.graph_counts() == {"captured": 0, "replayed": 3, "eager": 0}
    fit.reset_graph_counts()
    assert fit.graph_counts() == {"captured": 0, "replayed": 0, "eager": 0}


def test_host_counts_round_trip():
    cuda.reset_launch_counts()
    spectral.reset_spectral_counts()
    before = fit._host_counts()
    cuda.counter("gram").launches += 2
    spectral.REFINEMENTS[24] += 1
    delta = fit._host_counts() - before
    assert delta == {("launches", "gram"): 2, ("jacobi", 24): 1}
    fit._add_counts(delta)
    assert cuda.launch_counts()["gram"] == 4
    assert spectral.spectral_counts()["jacobi"] == {24: 2}
    fit._add_counts(delta, -1)
    assert cuda.launch_counts()["gram"] == 2
    cuda.reset_launch_counts()
    spectral.reset_spectral_counts()


def test_keyless_loss_never_engages():
    h, p, aux, x, y = _problem("cpu")
    fit.reset_graph_counts()
    _scan(_Keyless(_Gar0LossTracked(h)), p, aux, x, y, steps=4)
    fit.adam_scan(lambda q, xx: (q["hogp"]["noise_variance"] ** 2).sum(-1), p, 1e-2, 3,
                  loss_args=(x,))
    assert fit.graph_counts() == {"captured": 0, "replayed": 0, "eager": 0}


def test_jitter_made_once():
    a = hogp_mod._constant(1e-6, torch.float64, torch.device("cpu"))
    assert a is hogp_mod._constant(1e-6, torch.float64, torch.device("cpu"))
    assert a.dtype == torch.float64 and a.item() == 1e-6


# ---- the in-place step on the CPU ------------------------------------------

@pytest.mark.parametrize("refresh_every, steps", [(64, 12), (4, 11), (1, 3)])
def test_in_place_steps_match_keyless_cpu(refresh_every, steps):
    """Every step written into the first step's buffers gives the
    histories, params, optimizer state and aux of the step-by-step path, bit
    for bit; every step of a keyed loss counts as eager off the card."""
    h, p, aux, x, y = _problem("cpu")
    loss = _Gar0LossTracked(h, refresh_every)
    fit.reset_graph_counts()
    keyed = _scan(loss, p, aux, x, y, steps=steps)
    assert fit.graph_counts() == {"captured": 0, "replayed": 0, "eager": steps}
    _assert_same(keyed, _scan(_Keyless(loss), p, aux, x, y, steps=steps))


def test_in_place_steps_leave_the_inputs_alone_cpu():
    """The buffers are the first step's fresh tensors: the params, optimizer
    state and aux passed in, a resumed segment's included, are never
    written."""
    h, p, aux, x, y = _problem("cpu")
    loss = _Gar0LossTracked(h, 4)
    *_, carry = _scan(loss, p, aux, x, y, steps=3)
    inputs = tree_map(torch.clone, (p, aux, carry))
    _scan(loss, p, aux, x, y, steps=5)
    fit.adam_scan_aux(loss, carry[0], carry[4], 5e-2, 5, loss_args=(x, y), opt_state0=carry[1],
                      step0=1)
    _assert_same((p, aux, carry), inputs)


def test_rollback_in_place_matches_keyless_cpu():
    """A restart whose loss turns NaN mid-run rolls back as on the
    step-by-step path."""
    h, p, aux, x, y = _problem("cpu")
    mask = torch.tensor([True, False, False])
    runs = []
    for wrap in (lambda l: l, _Keyless):
        loss = _Poisoned(h, 64, calls=torch.zeros((), dtype=torch.int64), at=6, mask=mask)
        runs.append(_scan(wrap(loss), p, aux, x, y, steps=10))
    _assert_same(*runs)
    losses = runs[0][2]
    assert torch.isnan(losses[0, 5]) and torch.isfinite(losses[1:, 5]).all()
    assert torch.isfinite(losses[:, 6:]).all()


def test_adaptive_segments_match_keyless_cpu():
    h, p, aux, x, y = _problem("cpu")
    outs = []
    for wrap in (lambda l: l, _Keyless):
        best, res, refreshed = fit.fit_restarts_tracked_adaptive(
            wrap(_Gar0LossTracked(h, refresh_every=1 << 20)), p, aux, steps=40, lr=5e-2,
            segment=16, res_threshold=1e-4, loss_args=(x, y))
        outs.append((best, res.params, res.losses, refreshed))
    _assert_same(outs[0][:3], outs[1][:3])
    assert outs[0][3] == outs[1][3]


def test_train_gar_matches_keyless_cpu(monkeypatch):
    """A whole GAR fit with every stage tracked (threshold patched down):
    the same histories, winners and posterior as the step-by-step path."""
    from fidelityfusion_tpu_torch.data.pde import generate_poisson_mf_dataset

    monkeypatch.setattr(gar, "_TRACK_N_THRESHOLD", 8)
    x, ys = generate_poisson_mf_dataset(n_samples=40, resolutions=(4, 8), d_in=2, seed=1)
    outs = []
    for keyed in (True, False):
        if not keyed:
            monkeypatch.delattr(gar._TrackedSteps, "graph_key")
        outs.append(_fit_gar(x, ys, (24, 12), "cpu", steps=10))
    _assert_same(outs[0], outs[1])


def _fit_gar(x, ys, rows, device, steps):
    """``(histories, params, mean, var)`` of a GAR fit on nested ``rows``,
    with the launch and spectral counts of the fit."""
    from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager

    dm = MultiFidelityDataManager([
        {"raw_fidelity_name": str(i), "fidelity_indicator": i, "X": x[:n], "Y": ys[i][:n]}
        for i, n in enumerate(rows)])
    shapes = [f.shape[1:] for f in ys]
    model = gar.GAR(len(rows), [ARDKernel() for _ in rows], shapes, input_dim=x.shape[1],
                    device=device)
    cuda.reset_launch_counts()
    spectral.reset_spectral_counts()
    hists = gar.train_GAR(model, dm, max_iter=steps, lr_init=5e-2, n_restarts=3)
    with torch.no_grad():
        mean, var = model.forward(dm, x[-16:].astype(np.float32))
    return hists, model.params, mean, var, cuda.launch_counts(), spectral.spectral_counts()


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_graphed_gar_fit_matches_eager(card, monkeypatch):
    """GAR on Poisson fields at 1024/512 rows, both stages tracked:
    histories, winners, posterior means and variances, and every host
    counter, graphed against the same fit with the losses keyless."""
    from fidelityfusion_tpu_torch.data.pde import generate_poisson_mf_dataset

    x, ys = generate_poisson_mf_dataset(n_samples=1024 + 16, resolutions=(8, 16), d_in=4,
                                        seed=0)
    fit.reset_graph_counts()
    graphed = _fit_gar(x, ys, (1024, 512), card, steps=100)
    counts = fit.graph_counts()
    monkeypatch.delattr(gar._TrackedSteps, "graph_key")
    eager = _fit_gar(x, ys, (1024, 512), card, steps=100)
    assert counts == {"captured": 2, "replayed": 194, "eager": 6}
    assert graphed[4] == eager[4] and graphed[5] == eager[5]
    _assert_same(graphed[:4], eager[:4])


@pytest.mark.cuda
def test_graphed_rollback_matches_eager(card):
    """A restart whose loss turns NaN at a replayed step rolls back as on
    the step-by-step path, and the others train on."""
    h, p, aux, x, y = _problem(card, n=256, shape=(8, 8), restarts=4)
    mask = torch.tensor([True, False, True, False], device=card)
    runs = []
    for wrap in (lambda l: l, _Keyless):
        loss = _Poisoned(h, 64, calls=torch.zeros((), dtype=torch.int64, device=card), at=11,
                         mask=mask)
        fit.reset_graph_counts()
        runs.append(_scan(wrap(loss), p, aux, x, y, steps=20))
        if len(runs) == 1:
            assert fit.graph_counts()["replayed"] == 18
    _assert_same(*runs)
    losses = runs[0][2]
    assert torch.isnan(losses[mask, 10]).all() and torch.isfinite(losses[~mask, 10]).all()
    assert torch.isfinite(losses[:, 11:]).all()


@pytest.mark.cuda
def test_graph_memory_comes_back(card):
    """No graph outlives its stage: stage after stage, the device memory
    allocated and reserved once the results are dropped stays the same."""
    h, p, aux, x, y = _problem(card, n=512, shape=(8, 8), restarts=4)

    def stage():
        out = _scan(_Gar0LossTracked(h), p, aux, x, y, steps=30)
        del out
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated(card), torch.cuda.memory_reserved(card)

    stage()  # kernels, caches, cuBLAS's workspaces on the capture stream
    fit.reset_graph_counts()
    first, second = stage(), stage()
    assert fit.graph_counts()["captured"] == 2
    assert first == second
