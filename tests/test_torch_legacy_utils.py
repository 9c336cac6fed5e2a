"""The port's legacy wrappers (`models/legacy.py`), utilities
(`utils/config.py`, `logging.py`, `profiling.py`, `checkpoint.py`), the
non-SE kernels of `ops/kernels.py` and `CIGP(x64_factor=True)` against the
JAX package on the CPU, on the same numpy-seeded inputs.

Tolerances: a wrapper's `compute_loss` rtol 1e-5 (float32, same
parameters); its `forward` with the JAX-trained parameters carried across
within 1e-4 of the largest magnitude (means and variances); the loss
histories of a wrapper's `fit` within 1e-3 of max(|loss|, rows); a kernel's
Gram and its parameter gradients rtol 1e-5 (atol 1e-5 on gradients that
cancel to near zero); the x64 island's float64 NLML and gradients rtol
1e-10 of the JAX package's float64 ones, its float32 outputs rtol 1e-6,
its posterior mean within 1e-3 of the float64 closed form (the JAX test's
bar) and 1e-6 of the JAX posterior; the utilities exact."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidelityfusion_tpu.models import cigp as JCIGP
from fidelityfusion_tpu.models import legacy as JL
from fidelityfusion_tpu.ops import kernels as JK
from fidelityfusion_tpu.ops import linalg as JLA
from fidelityfusion_tpu.utils import checkpoint as JCK
from fidelityfusion_tpu.utils import config as JCF
from fidelityfusion_tpu.utils.logging import LogDebugger as JLogDebugger
from fidelityfusion_tpu_torch.convert import load_state, params_from_numpy
from fidelityfusion_tpu_torch.models import cigp as TCIGP
from fidelityfusion_tpu_torch.models import legacy as TL
from fidelityfusion_tpu_torch.ops import kernels as TK
from fidelityfusion_tpu_torch.utils import checkpoint as TCK
from fidelityfusion_tpu_torch.utils import config as TCF
from fidelityfusion_tpu_torch.utils import profiling as TP
from fidelityfusion_tpu_torch.utils.logging import LogDebugger
from fidelityfusion_tpu_torch.utils.tree import tree_leaves, tree_map
from tests.torch_port_checks import leaves, perturbed, value_and_grads_match


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, scale=None):
    """Within 1e-4 of ``scale`` (default: the largest magnitude of ``want``)."""
    want = np.asarray(want)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(np.asarray(got.detach()), want, atol=1e-4 * scale)


def _jax_hogp_f64(core, params, x, y, xt):
    """A JAX HOGP's posterior at ``xt`` recomputed in float64 (two float32
    ``eigh``s of these near-rank-one Grams part by ~1e-3 of the means; the
    port decomposes float32 Grams in float64)."""
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), params)
        x64, y64, xt64 = (jnp.asarray(np.asarray(a), jnp.float64) for a in (x, y, xt))

        def run(p, x, y, xt):
            _, state = core.nll_with_state(p, x, y)
            return core.predict(p, state, x, xt)

        return tuple(np.asarray(a) for a in jax.jit(run)(p64, x64, y64, xt64))


# ------------------------------------------------------------------ config


def test_config_merge_and_dot_access_match_jax():
    default = {"a": {"b": 1, "c": 2}, "d": 3, "k": {"SE": {"length_scale": 1.0}}}
    update = {"a": {"b": 10}, "k": {"ARD": {}}, "e": [1, 2]}
    out = TCF.update_dict_with_default(default, update)
    assert out == JCF.update_dict_with_default(default, update)
    assert out["a"] == {"b": 10, "c": 2} and default["a"]["b"] == 1  # no mutation
    cfg = TCF.make_config({"noise": {"init_value": 1.0}}, {"noise": {"init_value": 2.0}})
    jcfg = JCF.make_config({"noise": {"init_value": 1.0}}, {"noise": {"init_value": 2.0}})
    assert cfg.noise.init_value == jcfg.noise.init_value == 2.0
    assert cfg["noise"].to_dict() == jcfg["noise"].to_dict() and cfg.get("x", 5) == 5
    with pytest.raises(AttributeError):
        cfg.missing


def test_create_kernel_matches_jax():
    for cfg in ({"SE": {}}, {"kernel_res": {}}, {"ARD": {"length_scale": 1.0}}):
        assert type(TL.create_kernel(cfg)).__name__ == type(JL.create_kernel(cfg)).__name__
    with pytest.raises(KeyError):
        TL.create_kernel({"Matern": {}})


# ------------------------------------------------------------------ legacy wrappers


def test_legacy_cigp_matches_jax():
    """`tests/test_legacy.py`'s CIGP case: `compute_loss` at init, 20 steps
    of `fit` from the same init, and `forward` (mean (20, 1), diagonal
    variance (20, 1)) of the JAX model after its 150-step fit carried
    across."""
    rng = np.random.default_rng(0)
    x = rng.random((30, 1)).astype(np.float32) * 6
    y = np.sin(x).astype(np.float32)
    xt = np.linspace(0, 6, 20).reshape(-1, 1).astype(np.float32)
    jgp, gp = JL.LegacyCIGP({"input_dim": 1}), TL.LegacyCIGP({"input_dim": 1}, device="cpu")
    np.testing.assert_allclose(gp.compute_loss(x, y).item(), float(jgp.compute_loss(x, y)),
                               rtol=1e-5)
    losses, jlosses = gp.fit(x, y, max_iter=20), np.asarray(jgp.fit(x, y, max_iter=20))
    np.testing.assert_allclose(losses.numpy(), jlosses, atol=1e-3 * max(np.abs(jlosses).max(), 30))
    jgp.fit(x, y, max_iter=150, lr=5e-2)
    jmean, jvar = jgp.forward(xt)
    carried = TL.LegacyCIGP({"input_dim": 1}, device="cpu")
    load_state(carried, _np(jgp.params), train_data=(x, y))
    mean, var = carried.forward(xt)
    assert mean.shape == (20, 1) and var.shape == (20, 1)
    _close(mean, jmean)
    # variances: prior minus explained, float32 cancellation: 1e-4 of the prior
    _close(var, jvar, float(carried.core.kernel.signal_variance(carried.params["kernel"])))
    assert np.sqrt(np.mean((mean.numpy() - np.sin(xt)) ** 2)) < 0.15


def test_legacy_hogp_matches_jax():
    """`tests/test_legacy.py`'s HOGP case (its config's "ARD" merges over the
    default "SE", so both packages build the SE kernel): `compute_loss`
    rtol 1e-5; `forward` at init and after the JAX model's 30-step fit
    carried across, against the JAX posterior in float64.  Sigma = K_0 (x)
    K_modes + I has cond ~1.7e3 here and the near-rank-one float32 Grams'
    rounding moves the means by ~cond * 6e-8 (JAX's float32 forward 5.7e-4
    of their scale, the port's 1.6e-3): float32 forward within 5e-3 of the
    scale, and the wrapper's core in float64 within 1e-9."""
    rng = np.random.default_rng(1)
    x = rng.random((20, 2)).astype(np.float32)
    y = rng.standard_normal((20, 3, 4)).astype(np.float32) * 0.1
    cfg = {"input_dim": 2, "output_shape": (3, 4), "kernel": {"ARD": {}}}
    jh, h = JL.LegacyHOGP(cfg), TL.LegacyHOGP(cfg, device="cpu")
    np.testing.assert_allclose(h.compute_loss(x, y).item(), float(jh.compute_loss(x, y)),
                               rtol=1e-5)
    jh.fit(x, y, max_iter=30)
    carried = TL.LegacyHOGP(cfg, device="cpu")
    load_state(carried, _np(jh.params), train_data=(x, y))
    for model, jparams in ((h, _np(JL.LegacyHOGP(cfg).params)), (carried, _np(jh.params))):
        want = _jax_hogp_f64(jh.core, jparams, x, y, x[:5])
        mean, var = model.forward(x[:5])
        assert mean.shape == (5, 3, 4) and (var > 0).all()
        for got, w in zip((mean, var), want):
            np.testing.assert_allclose(got.numpy(), w, atol=5e-3 * np.abs(w).max())
        p64 = tree_map(lambda a: a.double(), model.params)
        x64, y64 = (torch.tensor(a, dtype=torch.float64) for a in (x, y))
        _, state = model.core.nll_with_state(p64, x64, y64)
        for got, w in zip(model.core.predict(p64, state, x64, x64[:5]), want):
            np.testing.assert_allclose(got.numpy(), w, atol=1e-9 * np.abs(w).max())


def test_legacy_fides_matches_jax():
    """`compute_loss` before `set_fidelity` raises AssertionError; the loss
    at the JAX init (its MC draws carried across) and `forward` after the
    JAX model's 150-step fit."""
    rng = np.random.default_rng(2)
    x = (rng.random((25, 1)) * 6).astype(np.float32)
    y = np.sin(x).astype(np.float32)
    jf, f = JL.LegacyFIDES(), TL.LegacyFIDES(device="cpu")
    with pytest.raises(AssertionError):
        f.compute_loss(x, y)
    with pytest.raises(AssertionError):
        f.forward(x)
    load_state(f, _np(jf.params))
    jf.set_fidelity(0, 1, 0, 1)
    f.set_fidelity(0, 1, 0, 1)
    np.testing.assert_allclose(f.compute_loss(x, y).item(), float(jf.compute_loss(x, y)),
                               rtol=1e-5)
    losses = f.fit(x, y, max_iter=20)
    assert torch.isfinite(losses).all() and losses[-1] < losses[0]
    jf.fit(x, y, max_iter=150, lr=5e-2)
    carried = TL.LegacyFIDES(device="cpu")
    load_state(carried, _np(jf.params), train_data=(x, y))
    carried.set_fidelity(0, 1, 0, 1)
    mean, var = carried.forward(x[:5])
    jmean, jvar = jf.forward(x[:5])
    assert mean.shape == (5, 1) and (var > 0).all()
    _close(mean, jmean)
    prior = carried.core.gram_args(carried.params, 1, carried.bounds)[1]
    _close(var, jvar, float(prior))


# ------------------------------------------------------------------ checkpoints, logs, timers


def test_pytree_checkpoint_roundtrip(tmp_path):
    """The port's npz round trip (tensors back on their leaves' dtype), and
    the file read by the JAX package's npz restore (leaves in the same
    order: `tree_leaves` and JAX's flattening agree on sorted-key trees)."""
    tree = {"a": torch.arange(4.0), "b": [torch.ones((2, 2)), torch.zeros(3)],
            "c": (torch.tensor(2.0), torch.tensor([1, 2]))}
    path = TCK.save_pytree(str(tmp_path / "ckpt"), tree)
    restored = TCK.restore_pytree(path, like=tree)
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jtree = {"a": jnp.zeros(4), "b": [jnp.zeros((2, 2)), jnp.zeros(3)],
             "c": (jnp.zeros(()), jnp.zeros(2, jnp.int32))}
    jrestored = JCK.restore_pytree(path, like=jtree)
    for a, b in zip(tree_leaves(tree), jax.tree_util.tree_leaves(jrestored)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        TCK.restore_pytree(path, like={"a": torch.zeros(4)})


def test_bo_state_roundtrip_both_ways(tmp_path):
    rng = np.random.default_rng(3)
    record = {"cost": [1.0, 2.0], "incumbents": [0.5, 0.7]}
    xs = [rng.random((5, 2)), torch.rand(3, 2, generator=torch.Generator().manual_seed(0))]
    ys = [rng.random((5, 1)), rng.random((3, 1))]
    for save, load in ((TCK.save_bo_state, JCK.load_bo_state),
                       (JCK.save_bo_state, TCK.load_bo_state)):
        p = str(tmp_path / f"bo_{save.__module__.split('.')[0]}.npz")
        save(p, record, [np.asarray(x) for x in xs] if save is JCK.save_bo_state else xs, ys)
        rec, xs2, ys2 = load(p)
        assert rec == record and len(xs2) == 2
        np.testing.assert_array_equal(xs2[1], np.asarray(xs[1]))
        np.testing.assert_array_equal(ys2[0], ys[0])


def test_log_debugger_records_and_rollback_match_jax(tmp_path, caplog):
    """`record_stage` keeps the history and logs its non-finite losses as an
    error; `save_rollback` writes the same arrays as the JAX package's."""
    dbg = LogDebugger("TEST", log_dir=str(tmp_path / "port"), capture_excepthook=False)
    with caplog.at_level(logging.INFO, logger="fidelityfusion.TEST"):
        dbg.record_stage(0, torch.tensor([3.0, 2.0, float("nan"), 1.0]))
        dbg.record_stage(1, np.array([[2.0, 1.0], [3.0, 0.5]]))
    assert len(dbg.histories) == 2
    assert any(r.levelname == "ERROR" and "1 non-finite" in r.getMessage() for r in caplog.records)
    assert (tmp_path / "port" / "TEST" / "train.log").exists()
    params = {"b": torch.ones(3), "a": [torch.arange(2.0), torch.tensor(5.0)]}
    path = dbg.save_rollback(params)
    jdbg = JLogDebugger("TEST", log_dir=str(tmp_path / "jax"), capture_excepthook=False)
    jpath = jdbg.save_rollback({"b": jnp.ones(3), "a": [jnp.arange(2.0), jnp.asarray(5.0)]})
    with np.load(path) as got, np.load(jpath) as want:
        # JAX flattens sorted keys ("a" first); the port writes tree_leaves order
        order = {"arr_0": "arr_2", "arr_1": "arr_0", "arr_2": "arr_1"}
        assert sorted(got.files) == sorted(want.files)
        for k in got.files:
            np.testing.assert_array_equal(got[k], want[order[k]])
    for h in dbg.logger.handlers + jdbg.logger.handlers:
        h.close()


def test_stopwatch_and_device_time_on_cpu(tmp_path):
    sw = TP.Stopwatch()
    for _ in range(3):
        with sw.measure("op"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    s = sw.summary()["op"]
    assert s["count"] == 3 and s["total_s"] > 0 and sw.rate("op") == pytest.approx(3 / s["total_s"])
    assert sw.rate("never") == 0.0
    a = torch.randn(384, 384, generator=torch.Generator().manual_seed(0))

    def factory(L):
        def run():
            out = a
            for _ in range(L):
                out = torch.tanh(out @ a)
            return out.sum()
        return run

    per_op = TP.device_time(factory, L1=2, L2=12, reps=5)
    assert np.isfinite(per_op) and 0.0 < per_op < 1.0, per_op
    with TP.profiler_trace(str(tmp_path / "trace")):
        torch.ones(8) * 2
    assert any((tmp_path / "trace").iterdir())


# ------------------------------------------------------------------ kernels


def _kernel_pair(name):
    return {
        "Matern-0.5": (JK.MaternKernel(nu=0.5), TK.MaternKernel(nu=0.5)),
        "Matern-1.5": (JK.MaternKernel(nu=1.5, rho=0.7), TK.MaternKernel(nu=1.5, rho=0.7)),
        "Matern-2.5": (JK.MaternKernel(nu=2.5), TK.MaternKernel(nu=2.5)),
        "Linear": (JK.LinearKernel(), TK.LinearKernel()),
        "RQ": (JK.RationalQuadraticKernel(), TK.RationalQuadraticKernel()),
        "Sum": (JK.SumKernel(JK.ARDKernel(), JK.LinearKernel()),
                TK.SumKernel(TK.ARDKernel(), TK.LinearKernel())),
        "Product": (JK.ProductKernel(JK.MaternKernel(nu=1.5), JK.SquaredExponentialKernel()),
                    TK.ProductKernel(TK.MaternKernel(nu=1.5), TK.SquaredExponentialKernel())),
        "MaternScalar": (JK.MaternKernelScalarLengthScale(),
                         TK.MaternKernelScalarLengthScale()),
    }[name]


@pytest.mark.parametrize("name", ["Matern-0.5", "Matern-1.5", "Matern-2.5", "Linear", "RQ",
                                  "Sum", "Product", "MaternScalar"])
def test_kernel_gram_and_gradients_match_jax(name):
    """The Gram (and its diagonal) and the gradient of a weighted sum of it
    in every parameter, rtol 1e-5, at perturbed parameters; a restart batch
    of two parameter sets gives each one's Gram; `trainable_mask` marks
    every leaf trainable, as the JAX package's does."""
    rng = np.random.default_rng(7)
    jk, tk = _kernel_pair(name)
    p = perturbed(jk.init_params(3), rng, scale=0.2)
    x1 = rng.standard_normal((14, 3)).astype(np.float32)
    x2 = rng.standard_normal((11, 3)).astype(np.float32)
    wts = rng.standard_normal((14, 11)).astype(np.float32)
    jfn = lambda q: jnp.sum(jk(q, jnp.asarray(x1), jnp.asarray(x2)) * wts)  # noqa: E731
    tfn = lambda q: (tk(q, torch.tensor(x1), torch.tensor(x2)) * torch.tensor(wts)).sum()  # noqa
    value_and_grads_match(jfn, tfn, p, rtol=1e-5, atol=1e-5)
    tp, jp = params_from_numpy(p, "cpu"), jax.tree_util.tree_map(jnp.asarray, p)
    np.testing.assert_allclose(tk(tp, torch.tensor(x1), torch.tensor(x2)).numpy(),
                               np.asarray(jk(jp, jnp.asarray(x1), jnp.asarray(x2))), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tk.diag(tp, torch.tensor(x1)).numpy(),
                               np.asarray(jk.diag(jp, jnp.asarray(x1))), rtol=1e-5, atol=1e-6)
    batch = params_from_numpy(jax.tree_util.tree_map(lambda a: np.stack([a, 1.5 * a]), p), "cpu")
    second = params_from_numpy(jax.tree_util.tree_map(lambda a: 1.5 * a, p), "cpu")
    got = tk(batch, torch.tensor(x1), torch.tensor(x2))
    assert got.shape == (2, 14, 11)
    torch.testing.assert_close(got[1], tk(second, torch.tensor(x1), torch.tensor(x2)))
    assert leaves(TK.trainable_mask(tk, tp)) == leaves(JK.trainable_mask(jk, jp))


def test_cigp_and_hogp_over_a_matern_kernel_match_jax():
    """A CIGP over a non-SE kernel: the nugget added after the Gram, the
    NLML rtol 1e-5 and `predict_diag` (its noise floored by the mean prior
    variance at the training inputs) against the JAX package's; a HOGP
    over it (jitter and y_var on K_0's diagonal): the NLML rtol 1e-5."""
    rng = np.random.default_rng(4)
    x = rng.random((40, 2)).astype(np.float32) * 3
    y = np.sin(x.sum(1, keepdims=True)).astype(np.float32)
    xt = rng.random((7, 2)).astype(np.float32) * 3
    jg, tg = JCIGP.CIGP(JK.MaternKernel(nu=1.5)), TCIGP.CIGP(TK.MaternKernel(nu=1.5))
    p = perturbed(jg.init_params(2), rng, scale=0.2)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p), params_from_numpy(p, "cpu")
    np.testing.assert_allclose(tg.nll(tp, torch.tensor(x), torch.tensor(y)).item(),
                               float(jax.jit(jg.nll)(jp, jnp.asarray(x), jnp.asarray(y))),
                               rtol=1e-5)
    for got, want in zip(tg.predict_diag(tp, torch.tensor(x), torch.tensor(y), torch.tensor(xt)),
                         jax.jit(jg.predict_diag)(jp, jnp.asarray(x), jnp.asarray(y),
                                                  jnp.asarray(xt))):
        _close(got, want)
    # a HOGP over it: the jitter and y_var added after the Gram
    from fidelityfusion_tpu.models.hogp import HOGP as JHOGP
    from fidelityfusion_tpu_torch.models.hogp import HOGP as THOGP

    yf = rng.standard_normal((40, 3, 2)).astype(np.float32)
    yv = (0.1 * rng.random(40)).astype(np.float32)
    jh, th = JHOGP(JK.MaternKernel(nu=1.5), (3, 2)), THOGP(TK.MaternKernel(nu=1.5), (3, 2))
    hp = perturbed(jh.init_params(2), rng, scale=0.2)
    np.testing.assert_allclose(
        th.nll(params_from_numpy(hp, "cpu"), torch.tensor(x), torch.tensor(yf),
               torch.tensor(yv)).item(),
        float(jax.jit(jh.nll)(jax.tree_util.tree_map(jnp.asarray, hp), jnp.asarray(x),
                              jnp.asarray(yf), jnp.asarray(yv))), rtol=1e-5)


# ------------------------------------------------------------------ x64_factor


def _x64_case(noise=1e-5):
    """`tests/test_cigp.py:test_x64_factor_escape_hatch`'s fixture: an SE
    Gram at noise 1e-5 (cond ~4e6 at n = 256, beyond float32)."""
    rng = np.random.default_rng(0)
    n = 256
    x = (rng.random((n, 1)) * 20).astype(np.float32)
    y = np.sin(x).astype(np.float32)
    p = {"kernel": {"length_scale": np.zeros(1, np.float32),
                    "signal_variance": np.zeros(1, np.float32)},
         "log_beta": np.array([-np.log(noise)], np.float32)}
    return x, y, p


@pytest.mark.parametrize("noise,grad_rtol", [(1e-3, 1e-10), (1e-5, 1e-8)])
def test_x64_factor_nll_and_gradients_match_jax_in_float64(noise, grad_rtol):
    """The float64 NLML (rtol 1e-10) and its gradients (parameters in
    float64) against the JAX package's float64 island recomputed from its
    own kernel and linalg (`models/cigp.py:_x64_nll_fn_cached`): rtol 1e-10
    at noise 1e-3 (cond(Sigma) ~1e4); at the escape hatch's noise 1e-5
    (cond ~4e6) two float64 solves' gradients part by ~cond * 2e-16, so
    1e-8 there.  The float32 `nll` and its gradient against JAX's `nll` at
    rtol 1e-6; a masked call raises, as in JAX."""
    x, y, p = _x64_case(noise)
    jg = JCIGP.CIGP(kernel=JK.SquaredExponentialKernel(), jitter=0.0, min_noise=0.0,
                    x64_factor=True)
    tg = TCIGP.CIGP(kernel=TK.SquaredExponentialKernel(), jitter=0.0, min_noise=0.0,
                    x64_factor=True)
    with jax.enable_x64(True):
        def loss64(q):
            K = jg.kernel.apply(q["kernel"], jnp.asarray(x, jnp.float64),
                                jnp.asarray(x, jnp.float64))
            noise = jg.noise(q, jnp.mean(jnp.diagonal(K)).astype(jnp.float32)).astype(jnp.float64)
            Sigma = JLA.assemble_sigma(K, noise, jitter=jg.jitter,
                                       y_var=jnp.zeros(len(x), jnp.float64))
            return JLA.mvn_nll(Sigma, jnp.asarray(y, jnp.float64))

        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), p)
        jv, jgrad = jax.value_and_grad(loss64)(p64)
        jv, jgrad = float(jv), _np(jgrad)
    tp = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a, np.float64),
                                                       requires_grad=True), p)
    v = tg.nll64(tp, torch.tensor(x), torch.tensor(y))
    v.backward()
    assert v.dtype == torch.float64
    np.testing.assert_allclose(v.item(), jv, rtol=1e-10)
    for a, t in zip(leaves(jgrad), leaves(tp)):
        np.testing.assert_allclose(t.grad.numpy(), a, rtol=grad_rtol)
    value_and_grads_match(lambda q: jg.nll(q, jnp.asarray(x), jnp.asarray(y)),
                          lambda q: tg.nll(q, torch.tensor(x), torch.tensor(y)), p, rtol=1e-6,
                          atol=1e-6)
    with pytest.raises(NotImplementedError):
        tg.nll(params_from_numpy(p, "cpu"), torch.tensor(x), torch.tensor(y),
               mask=torch.ones(len(x), dtype=torch.bool))


def test_x64_factor_trains_and_predicts_like_the_float64_closed_form():
    """Where the float32 path is not finite: 10 Adam steps stay finite and
    do not rise; the posterior mean within 1e-3 of the float64 closed form
    and 1e-6 of the JAX x64 posterior, variances positive; `predict`'s
    diagonal equals `predict_diag`'s."""
    import scipy.linalg as sla

    from fidelityfusion_tpu_torch.train.fit import fit

    x, y, p = _x64_case()
    gp32 = TCIGP.CIGP(kernel=TK.SquaredExponentialKernel(), jitter=0.0, min_noise=0.0,
                      se_analytic_nll=False, hybrid_nll=False)
    v32 = gp32.nll(params_from_numpy(p, "cpu"), torch.tensor(x), torch.tensor(y))
    assert not torch.isfinite(v32), "fixture no longer ill-conditioned"
    tg = TCIGP.CIGP(kernel=TK.SquaredExponentialKernel(), jitter=0.0, min_noise=0.0,
                    x64_factor=True)
    res = fit(tg.nll, params_from_numpy(p, "cpu"), steps=10, lr=1e-2,
              loss_args=(torch.tensor(x), torch.tensor(y)))
    assert torch.isfinite(res.losses).all() and res.losses[-1] <= res.losses[0]

    x64 = x.astype(np.float64)
    K = np.exp(-0.5 * (x64 - x64.T) ** 2)
    L = np.linalg.cholesky(K + 1e-5 * np.eye(len(x)))
    alpha = sla.cho_solve((L, True), y.astype(np.float64))
    xt = np.linspace(0, 20, 16).reshape(-1, 1).astype(np.float32)
    m_ref = np.exp(-0.5 * (x64 - xt.astype(np.float64).T) ** 2).T @ alpha
    tp = params_from_numpy(p, "cpu")
    mean, var = tg.predict_diag(tp, torch.tensor(x), torch.tensor(y), torch.tensor(xt))
    np.testing.assert_allclose(mean.numpy(), m_ref, atol=1e-3)
    assert (var > 0).all() and mean.dtype == torch.float32
    jg = JCIGP.CIGP(kernel=JK.SquaredExponentialKernel(), jitter=0.0, min_noise=0.0,
                    x64_factor=True)
    jmean, jvar = jg.predict_diag(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                                  jnp.asarray(y), jnp.asarray(xt))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-6, atol=1e-9)
    full_mean, cov = tg.predict(tp, torch.tensor(x), torch.tensor(y), torch.tensor(xt))
    torch.testing.assert_close(full_mean, mean)
    torch.testing.assert_close(cov.diagonal(), var, rtol=1e-6, atol=1e-9)
    assert cov.shape == (16, 16)
