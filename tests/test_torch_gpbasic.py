"""The port's `MCFidelityKernel`, `GPBasic` and restart ladder against the
JAX package on the CPU, on the same seeded inputs and parameters (the JAX
MC draws carried across with `convert.py`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidelityfusion_tpu.models import cigp as JC
from fidelityfusion_tpu.ops import kernels as JK
from fidelityfusion_tpu.train.fit import gp_restart_batch as j_restart_batch
from fidelityfusion_tpu_torch.convert import params_from_numpy
from fidelityfusion_tpu_torch.models import cigp as TC
from fidelityfusion_tpu_torch.ops import kernels as TK
from fidelityfusion_tpu_torch.train import fit as TF
from tests.torch_port_checks import leaves, perturbed, value_and_grads_match


def _kernels(name):
    if name == "ARD":
        return JK.ARDKernel(), TK.ARDKernel()
    if name == "SE":
        return JK.SquaredExponentialKernel(), TK.SquaredExponentialKernel()
    jb, tb = _kernels(name.split("-")[1])
    return (JK.MCFidelityKernel(base=jb, lf=1.0, hf=2.0),
            TK.MCFidelityKernel(base=tb, lf=1.0, hf=2.0))


@pytest.mark.parametrize("name", ["MC-ARD", "MC-SE"])
def test_mc_fidelity_kernel_value_and_grad_match_jax(name):
    """Gram and the gradient of a weighted sum of it, every parameter
    (the fidelity factor's b, length scale and signal variance, the
    base kernel's), rtol 1e-4."""
    rng = np.random.default_rng(0)
    jk, tk = _kernels(name)
    p = perturbed(jk.init_params(2), rng)
    x1, x2 = rng.standard_normal((20, 2)), rng.standard_normal((15, 2))
    wts = rng.standard_normal((20, 15))
    jx1, jx2 = jnp.asarray(x1, jnp.float32), jnp.asarray(x2, jnp.float32)
    tx1, tx2 = torch.tensor(x1, dtype=torch.float32), torch.tensor(x2, dtype=torch.float32)
    tp = value_and_grads_match(lambda q: jnp.sum(jk.apply(q, jx1, jx2) * wts),
                               lambda q: (tk.apply(q, tx1, tx2) * torch.tensor(wts)).sum(),
                               p, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tk.apply(tp, tx1, tx2).detach().numpy(), np.asarray(jax.jit(
        jk.apply)(jax.tree_util.tree_map(jnp.asarray, p), jx1, jx2)), rtol=1e-4, atol=1e-7)


def test_mc_fidelity_kernel_batched_factor_matches_unbatched():
    """With a leading restart axis on b, the length scales and the z draws
    (as `stack_params` builds it), each restart's factor is the unbatched
    one's."""
    tk = _kernels("MC-ARD")[1]
    p = tk.init_params(1, device="cpu")
    ps = [dict(p, b=torch.tensor(b), length_scales=torch.tensor([ls]))
          for b, ls in ((0.5, 1.0), (1.0, 0.3), (2.0, 3.0))]
    batch = TF.stack_params(ps)
    assert isinstance(batch["_z"], tuple) and batch["_z"][0].shape == (3, tk.n_mc)
    assert TF._frozen_mask(batch)["_z"] == (False, False)
    got = tk.fidelity_factor(batch)
    want = torch.stack([tk.fidelity_factor(q) for q in ps])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def _gp_case(case, rng, n=48):
    x = rng.standard_normal((n, 1)).astype(np.float32)
    y = (np.sin(2 * x) + 0.1 * rng.standard_normal((n, 1))).astype(np.float32)
    y_var = (0.05 * rng.random(n)).astype(np.float32) if case == "y_var" else None
    mask = (np.arange(n) < n - 9) if case == "mask" else None
    return x, y, y_var, mask


@pytest.mark.parametrize("kernel", ["ARD", "MC-ARD"])
@pytest.mark.parametrize("case", ["plain", "y_var", "mask", "relative_jitter"])
def test_gpbasic_nll_and_predictions_match_jax(kernel, case):
    """`GPBasic.nll` (value rtol 1e-5, gradients 2e-3: the bars of
    tests/test_linalg.py), `predict` and `predict_diag` (no noise in
    either) within rtol 1e-4, of their scale, of the JAX package's in
    float64, the bar of tests/test_torch_ar.py's forward: the port's
    posterior multiplies by W = inv(L) where the JAX package solves with L,
    which costs float32 accuracy (3.0e-5 of the means' scale at worst here,
    the JAX package's float32 7.4e-6).  A posterior (co)variance's scale
    is the prior variance it cancels from."""
    rng = np.random.default_rng(1)
    jk, tk = _kernels(kernel)
    rel = case == "relative_jitter"
    jgp, tgp = JC.GPBasic(kernel=jk, relative_jitter=rel), TC.GPBasic(kernel=tk, relative_jitter=rel)
    p = perturbed(jgp.init_params(1), rng, scale=0.2)
    p["noise_variance"] = np.asarray([0.15], np.float32)
    x, y, y_var, mask = _gp_case(case, rng)
    xt = np.linspace(-2, 2, 17, dtype=np.float32)[:, None]
    J = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    T = lambda a: None if a is None else torch.tensor(a)  # noqa: E731
    tp = value_and_grads_match(
        lambda q: jgp.nll(q, J(x), J(y), y_var=J(y_var), mask=J(mask)),
        lambda q: tgp.nll(q, T(x), T(y), y_var=T(y_var), mask=T(mask)),
        p, rtol=1e-5, atol=1e-5, grad_rtol=2e-3)
    with torch.no_grad(), jax.enable_x64(True):
        J64 = lambda a: None if a is None else jnp.asarray(  # noqa: E731
            a, jnp.float64 if a.dtype == np.float32 else a.dtype)
        jp64 = jax.tree_util.tree_map(J64, p)
        prior = float(tgp.kernel.diag(tp["kernel"], T(xt)).max())
        for fn in ("predict", "predict_diag"):
            got = getattr(tgp, fn)(tp, T(x), T(y), T(xt), y_var=T(y_var), mask=T(mask))
            want = jax.jit(getattr(jgp, fn))(jp64, J64(x), J64(y), J64(xt), y_var=J64(y_var),
                                             mask=J64(mask))
            # scales: the means' own, the prior variance for the
            # (co)variances, which cancel from it
            for g, w, scale in zip(got, want, (np.abs(np.asarray(want[0])).max(), prior)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4 * scale)


def test_restart_ladder_matches_jax_for_gpbasic_over_mc_kernel():
    """`gp_restart_batch` on a GPBasic-over-MCFidelityKernel parameter dict:
    restarts 0-7 (the deterministic ladder, with noise_variance 0.3 and the
    base kernel's length scales set) equal the JAX package's leaf by leaf."""
    rng = np.random.default_rng(2)
    jk, tk = _kernels("MC-ARD")
    p = perturbed(JC.GPBasic(kernel=jk).init_params(1), rng)
    x = rng.random((40, 1)).astype(np.float32) * 5
    j_out = j_restart_batch(jk, jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), 8,
                            jax.random.PRNGKey(0))
    t_out = TF.gp_restart_batch(tk, params_from_numpy(p, "cpu"), torch.tensor(x), 8)
    assert len(t_out) == 8
    for i, (jq, tq) in enumerate(zip(j_out, t_out)):
        if i:
            assert float(tq["noise_variance"][0]) == np.float32(0.3)
        assert len(leaves(jq)) == len(leaves(tq)) == 8
        for a, b in zip(leaves(jq), leaves(tq)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
