"""The port's real-application objectives (`fidelityfusion_tpu_torch/
data/real_app.py`) and `CIGPWithMean` against the JAX package on the CPU.

`jax.random` draws the JAX objectives' synthetic datasets, initial weights
and dropout masks; no torch stream reproduces them, so each comparison
feeds the JAX draws to the port (``data=``, ``params=`` through
`convert.net_params_from_numpy`, ``keep_masks=``).  The JAX `_train_one`
returns only the accuracy: its final validation logits are read inside
its own jitted code, at the `jnp.argmax` over them, by a `jax.debug.
callback` (the module's `jnp` seen through a proxy; nothing of the JAX
package is edited).

Tolerances: final validation logits within 1e-4 of their max |.| of
JAX's, accuracy within 1/n_val.  `DigitsMLPObjective` is held at learning
rates up to 10^-2.5: at 1e-2 its ReLU units near their kink, with Adam's
eps against gradients of ~3e-8 in the first step, turn float32 rounding
differences of ~1e-8 in the gradient into logits 1.1e-4 to 3.1e-4 apart
after 10-20 epochs, with equal accuracies (ROADMAP Queue 3).
`CIGPWithMean`: NLML and posterior at given parameters within rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidelityfusion_tpu.data import real_app as JRA
from fidelityfusion_tpu.models.cigp import CIGPWithMean as JCIGPWithMean
from fidelityfusion_tpu.ops import kernels as JK
from fidelityfusion_tpu_torch.convert import net_params_from_numpy, params_from_numpy
from fidelityfusion_tpu_torch.data import real_app as TRA
from fidelityfusion_tpu_torch.models.cigp import CIGPWithMean
from fidelityfusion_tpu_torch.ops import kernels as TK
from fidelityfusion_tpu_torch.train.fit import fit

from tests.torch_port_checks import perturbed


class _LogitsCapture:
    """`jax.numpy` as the JAX module sees it, with `argmax` recording its
    argument (the final validation logits) through a debug callback."""

    def __init__(self):
        self.logits = None

    def __getattr__(self, name):
        return getattr(jnp, name)

    def argmax(self, a, axis=None):
        jax.debug.callback(lambda v: setattr(self, "logits", np.asarray(v)), a)
        return jnp.argmax(a, axis=axis)


@pytest.fixture
def capture(monkeypatch):
    cap = _LogitsCapture()
    monkeypatch.setattr(JRA, "jnp", cap)
    return cap


def _jax_params(name, a, b, seed=0):
    """The initial weights the JAX `_train_one` draws at (a, b)."""
    normal = jax.random.normal
    if name == "MLP":
        width = max(4, int(round(b * 64)))
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
        return {"w1": normal(k1, (2, width)) * 0.5, "b1": jnp.zeros((width,)),
                "w2": normal(k2, (width, 2)) * 0.5, "b2": jnp.zeros((2,))}, None
    if name == "CNN":
        ch = max(2, int(round(b * 16)))
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
        return {"conv": normal(k1, (3, 3, 1, ch)) * 0.3, "w": normal(k2, (16 * ch, 4)) * 0.1,
                "b": jnp.zeros((4,))}, None
    if name == "DigitsMLP":
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
        return {"w1": normal(k1, (64, 64)) / 8.0, "b1": jnp.zeros((64,)),
                "w2": normal(k2, (64, 10)) / np.sqrt(64), "b2": jnp.zeros((10,))}, k3
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(seed + 7), 4)
    return {"k1": normal(k1, (3, 3, 1, 8)) * 0.3, "b1": jnp.zeros((8,)),
            "k2": normal(k2, (3, 3, 8, 16)) * 0.15, "b2": jnp.zeros((16,)),
            "w": normal(k3, (256, 10)) / np.sqrt(256), "b": jnp.zeros((10,))}, k4


def _objectives(name):
    if name.startswith("Digits"):
        pytest.importorskip("sklearn")
        jcls, tcls = getattr(JRA, f"{name}Objective"), getattr(TRA, f"{name}Objective")
        return jcls(), tcls(device="cpu")
    jcls = {"MLP": JRA.MLPTrainingObjective, "CNN": JRA.CNNTrainingObjective}[name]
    tcls = {"MLP": TRA.MLPTrainingObjective, "CNN": TRA.CNNTrainingObjective}[name]
    j = jcls(2)
    data = tuple(np.asarray(a) for a in (j.X_train, j.y_train, j.X_val, j.y_val))
    return j, tcls(2, data=data, device="cpu")


# (objective, a, b, epochs): (log10 lr, width fraction) or (dropout, log10 lr)
CASES = [("MLP", -2.0, 0.5, 20), ("MLP", -1.2, 0.9, 10),
         ("CNN", -2.0, 0.5, 20), ("CNN", -1.5, 0.9, 10),
         ("DigitsMLP", 0.3, -3.0, 20), ("DigitsMLP", 0.5, -2.5, 10),
         ("DigitsCNN", 0.0, -2.5, 10), ("DigitsCNN", 0.3, -2.5, 20)]


@pytest.mark.parametrize("name,a,b,epochs", CASES, ids=[f"{c[0]}-{c[1]}-{c[2]}-{c[3]}"
                                                         for c in CASES])
def test_train_one_matches_jax(capture, name, a, b, epochs):
    """`_train_one` from JAX's data, initial weights and (dropout > 0) keep
    masks: the final validation logits and the accuracy.  DigitsCNN's
    cases cover the optax RMSprop rule, the others optax's Adam."""
    j, t = _objectives(name)
    acc_j = j._train_one(a, b, epochs=epochs)
    jax.effects_barrier()
    logits_j = capture.logits
    params, mask_key = _jax_params(name, a, b)
    given = {"params": net_params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")}
    if mask_key is not None and a > 0:
        shape = t.dropped_shape()
        given["keep_masks"] = np.stack([
            np.asarray(jax.random.bernoulli(k, 1.0 - a, shape))
            for k in jax.random.split(mask_key, epochs)])
    logits = t._val_logits(a, b, epochs, **given)
    n_val = len(logits_j)
    assert logits.shape == logits_j.shape
    err = np.abs(logits.numpy() - logits_j).max() / np.abs(logits_j).max()
    assert err <= 1e-4, err
    assert abs(t.accuracy(logits) - acc_j) <= 1.0 / n_val, (t.accuracy(logits), acc_j)


def test_objective_protocol_and_own_draws():
    """The port's own draws: `initiate_data` shapes and ranges as
    `tests/test_real_app_native.py` asks of JAX, `get_data` deterministic,
    accuracies in [0, 1]; the keep masks keep about 1 - rate."""
    mlp = TRA.MLPTrainingObjective(2, device="cpu")
    xs, ys = mlp.initiate_data({1: 4, 2: 3}, seed=1)
    assert xs[0].shape == (4, 2) and ys[0].shape == (4, 1) and ys[1].shape == (3, 1)
    assert np.all((ys[0] >= 0) & (ys[0] <= 1))
    x = np.array([[-2.0, 0.8]])
    acc1, acc1b, acc2 = mlp.get_data(x, 1)[0, 0], mlp.get_data(x, 1)[0, 0], mlp.get_data(x, 2)[0, 0]
    assert acc1 == acc1b and acc2 >= acc1 - 0.1
    cnn = TRA.CNNTrainingObjective(2, device="cpu")
    assert cnn.X_train.shape == (256, 8, 8, 1) and cnn.X_val.shape == (128, 8, 8, 1)
    assert 0.0 <= cnn.get_data(np.array([[-1.5, 0.9]]), 2)[0, 0] <= 1.0
    assert cnn.search_range == [[-4.0, -1.0], [0.0, 1.0], [0, 1]]
    sklearn = pytest.importorskip("sklearn")  # noqa: F841
    dig = TRA.DigitsMLPObjective(device="cpu")
    keep = dig.keep_masks(0.3, 10)
    assert keep.shape == (10, 1200, 64) and abs(keep.float().mean().item() - 0.7) < 0.01


def _cigp_with_mean_problem():
    rng = np.random.default_rng(0)
    x = (rng.random((40, 1)) * 6).astype(np.float32)
    y = (np.sin(x) + 10.0 + 0.05 * rng.standard_normal((40, 1))).astype(np.float32)
    return x, y


def test_cigp_with_mean_matches_jax_at_given_params():
    """`init_params(y=...)` starts the constant at the same mean; the NLML
    and the posterior mean and covariance at perturbed parameters within
    rtol 1e-4 (the covariance within 1e-4 of its largest entry)."""
    x, y = _cigp_with_mean_problem()
    jgp, tgp = JCIGPWithMean(kernel=JK.ARDKernel()), CIGPWithMean(kernel=TK.ARDKernel())
    jp0 = jgp.init_params(1, y=jnp.asarray(y))
    tp0 = tgp.init_params(1, y=y, device="cpu")
    assert float(tp0["const_mean"][0]) == pytest.approx(float(jp0["const_mean"][0]), rel=1e-6)
    p = perturbed(jp0, np.random.default_rng(1), scale=0.2)
    jpar = jax.tree_util.tree_map(jnp.asarray, p)
    tpar = params_from_numpy(p, "cpu")
    xt = np.linspace(0, 6, 20, dtype=np.float32).reshape(-1, 1)
    jv = float(jgp.nll(jpar, jnp.asarray(x), jnp.asarray(y)))
    tv = float(tgp.nll(tpar, torch.as_tensor(x), torch.as_tensor(y)))
    assert tv == pytest.approx(jv, rel=1e-4)
    jm, jc = (np.asarray(a) for a in jgp.predict(jpar, jnp.asarray(x), jnp.asarray(y),
                                                 jnp.asarray(xt)))
    tm, tc = tgp.predict(tpar, torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(xt))
    np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-4)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-4, atol=1e-4 * np.abs(jc).max())


def test_cigp_with_mean_learns_offset():
    """The port's counterpart of `tests/test_real_app_native.py:
    test_cigp_with_mean_learns_offset`: 300 Adam steps learn the offset of
    sin(x) + 10 to within 1, the posterior mean to RMSE < 0.2."""
    x, y = (torch.as_tensor(a) for a in _cigp_with_mean_problem())
    gp = CIGPWithMean(kernel=TK.ARDKernel())
    params = gp.init_params(1, y=y, device="cpu")
    res = fit(lambda p: gp.nll(p, x, y), params, steps=300, lr=5e-2)
    assert abs(float(res.params["const_mean"][0]) - 10.0) < 1.0
    xt = torch.linspace(0, 6, 20).reshape(-1, 1)
    mean, _ = gp.predict(res.params, x, y, xt)
    rmse = float(torch.sqrt(torch.mean((mean.ravel() - (torch.sin(xt.ravel()) + 10)) ** 2)))
    assert rmse < 0.2


def test_mf_bo_discrete_on_mlp_objective_cpu():
    """Two iterations of `mf_bo_discrete` (AR surrogate) on the MLP
    objective, on the CPU: incumbents never fall, cost grows, every value
    an accuracy in [0, 1]."""
    from fidelityfusion_tpu_torch.bo.loop import mf_bo_discrete

    rec = mf_bo_discrete(TRA.MLPTrainingObjective(2, device="cpu"), model_name="AR",
                         bo_iterations=2, init_index={1: 6, 2: 3}, seed=0, train_iters=30,
                         device="cpu")
    inc, cost = rec["incumbents"], rec["cost"]
    assert len(inc) == 2 and inc[1] >= inc[0] and cost[1] > cost[0]
    assert all(0.0 <= v <= 1.0 for v in inc)
