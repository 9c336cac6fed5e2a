"""The port's factorization kernels' plain versions (K2/K3a, K3b) against
the retired Pallas kernels in interpret mode, and `linalg.mvn_nll` and the
analytic-SE NLML against the JAX package's blocked, hybrid and analytic
NLMLs (values and gradients)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.retired.pallas_batched import cholesky_vmem, tri_inv_vmem
from benchmarks.retired.pallas_cholesky import cholesky_blocked
from fidelityfusion_tpu.ops import blocked as JB
from fidelityfusion_tpu.ops import fused_se as JS
from fidelityfusion_tpu_torch.ops import fused_se as TS
from fidelityfusion_tpu_torch.ops import linalg as TL
from fidelityfusion_tpu_torch.ops.chol import (
    chol_inv, chol_inv_padded, chol_inv_plain, tri_inv, tri_inv_plain)


def _spd(rng, n, R=None):
    shape = (n, n) if R is None else (R, n, n)
    A = rng.standard_normal(shape).astype(np.float32)
    return (A @ np.swapaxes(A, -1, -2) + n * np.eye(n, dtype=np.float32)).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


def test_chol_inv_plain_matches_pallas_cholesky_blocked():
    """K2's plain version against `cholesky_blocked(interpret=True)`, n=256."""
    S = _spd(np.random.default_rng(0), 256)
    want = np.asarray(cholesky_blocked(jnp.asarray(S), interpret=True))
    L, Wd = chol_inv_plain(_t(S)[None])
    np.testing.assert_allclose(L[0].numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    # the leaf inverses are the inverses of L's diagonal blocks
    for k in range(4):
        blk = L[0, 64 * k:64 * (k + 1), 64 * k:64 * (k + 1)]
        np.testing.assert_allclose((Wd[0, k] @ blk).numpy(), np.eye(64), atol=5e-5)


def test_chol_and_tri_inv_plain_match_pallas_batched():
    """K3a and K3b plain versions against `jax.vmap(cholesky_vmem)` and
    `jax.vmap(tri_inv_vmem)` in interpret mode (R = 2, n = 256)."""
    S = _spd(np.random.default_rng(1), 256, R=2)
    want_L = np.asarray(jax.vmap(lambda a: cholesky_vmem(a, interpret=True))(jnp.asarray(S)))
    want_W = np.asarray(jax.vmap(lambda a: tri_inv_vmem(a, interpret=True))(jnp.asarray(want_L)))
    L, Wd = chol_inv(_t(S))
    np.testing.assert_allclose(L.numpy(), want_L, rtol=1e-4, atol=1e-4 * np.abs(want_L).max())
    W = tri_inv(L, Wd)
    np.testing.assert_allclose(W.numpy(), want_W, rtol=1e-3, atol=1e-4 * np.abs(want_W).max())
    np.testing.assert_allclose(tri_inv_plain(L, Wd).numpy(), W.numpy())
    np.testing.assert_allclose((W @ L).numpy(), np.broadcast_to(np.eye(256), (2, 256, 256)),
                               atol=5e-5)


def test_chol_inv_f64_exact_and_nan_propagates():
    rng = np.random.default_rng(2)
    S = _spd(rng, 192).astype(np.float64)
    L, Wd = chol_inv(_t(S))
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(S), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose((tri_inv(L, Wd) @ L).numpy(), np.eye(192), atol=1e-13)
    S[100, 100] = -1.0  # indefinite: the factor must not come out finite
    assert not torch.isfinite(chol_inv(_t(S))[0]).all()
    with pytest.raises(ValueError, match="multiple of 64"):
        chol_inv(torch.eye(100))


def _jax_vg(fn, S, y):
    return jax.jit(jax.value_and_grad(fn, argnums=(0, 1)))(jnp.asarray(S), jnp.asarray(y))


def _torch_vg(fn, S, y):
    St, yt = _t(S).requires_grad_(), _t(y).requires_grad_()
    v = fn(St, yt)
    v.sum().backward()
    return v.detach().numpy(), St.grad.numpy(), yt.grad.numpy()


def _assert_vg(got, want):
    v, gS, gy = got
    wv, (wS, wy) = want
    np.testing.assert_allclose(v, np.asarray(wv), rtol=1e-5)
    np.testing.assert_allclose(gS, np.asarray(wS), rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(gy, np.asarray(wy), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n", [256, 300])
def test_mvn_nll_blocked_matches_jax(n):
    """Value and gradients at the tests/test_linalg.py:195 bars, including
    identity-row padding (n = 300, padded to 320)."""
    rng = np.random.default_rng(n)
    S, y = _spd(rng, n), rng.standard_normal((n, 2)).astype(np.float32)
    want = _jax_vg(lambda s, yy: JB.mvn_nll_blocked(s, yy, block=64), S, y)
    _assert_vg(_torch_vg(TL.mvn_nll, S, y), want)


def test_mvn_nll_blocked_mask_and_batch_match_jax():
    rng = np.random.default_rng(3)
    n, R = 200, 3
    S, y = _spd(rng, n, R=R), rng.standard_normal((R, n, 1)).astype(np.float32)
    mask = np.arange(n) < 170
    m = mask.astype(np.float32)
    S = S * (m[:, None] * m[None, :]) + np.diag(1.0 - m)  # identity rows
    jm, tm = jnp.asarray(mask), torch.tensor(mask)
    per_restart = jax.vmap(lambda s, yy: JB.mvn_nll_blocked(s, yy, mask=jm))
    want_v = np.asarray(jax.jit(per_restart)(jnp.asarray(S), jnp.asarray(y)))
    _, want_g = _jax_vg(lambda s, yy: jnp.sum(per_restart(s, yy)), S, y)
    got = _torch_vg(lambda s, yy: TL.mvn_nll(s, yy, mask=tm), S, y)
    _assert_vg(got, (want_v, want_g))


def test_mvn_nll_hybrid_matches_jax():
    rng = np.random.default_rng(4)
    n = 300
    S, y = _spd(rng, n), rng.standard_normal((n, 3)).astype(np.float32)
    want = _jax_vg(lambda s, yy: JB.mvn_nll_hybrid(s, yy, 128), S, y)
    _assert_vg(_torch_vg(TL.mvn_nll, S, y), want)


def test_tri_inv_gemm_and_hybrid_leaf():
    """`chol_inv_padded`'s crop is exact: 150 rows padded to 192 give the
    150-row factor and W L = I, in float64."""
    rng = np.random.default_rng(5)
    S = _spd(rng, 150).astype(np.float64)
    L = np.linalg.cholesky(S)
    Lp, Wp = chol_inv_padded(_t(S))
    assert Lp.shape == Wp.shape == (150, 150)
    np.testing.assert_allclose(Lp.numpy(), L, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(Wp.numpy() @ L, np.eye(150), atol=1e-12)


def test_se_nlml_matches_jax_with_zero_x_grad():
    """Value and analytic gradients against the JAX `se_nlml` (f32), with
    the nugget floor active in a second case; the x gradient is zero."""
    rng = np.random.default_rng(6)
    n, d = 160, 2
    x = (rng.random((n, 1)) * 3.0).astype(np.float32)
    y = rng.standard_normal((n, d)).astype(np.float32)
    for log_beta, min_noise in ((0.7, 0.0), (9.0, 0.3)):
        raw = {"kernel": {"length_scale": [-0.4], "signal_variance": [0.1]},
               "log_beta": [log_beta]}
        jp = {"kernel": {k: jnp.asarray(v, jnp.float32) for k, v in raw["kernel"].items()},
              "log_beta": jnp.asarray(raw["log_beta"], jnp.float32)}
        wv, wg = jax.jit(jax.value_and_grad(
            lambda p, xx, yy: JS.se_nlml(p, xx, yy, min_noise=min_noise), argnums=(0, 1, 2)))(
                jp, jnp.asarray(x), jnp.asarray(y))
        tp = {"kernel": {k: torch.tensor(v, requires_grad=True) for k, v in raw["kernel"].items()},
              "log_beta": torch.tensor(raw["log_beta"], requires_grad=True)}
        xt, yt = _t(x).requires_grad_(), _t(y).requires_grad_()
        v = TS.se_nlml(tp, xt, yt, min_noise=min_noise)
        v.backward()
        np.testing.assert_allclose(float(v), float(wv), rtol=1e-5)
        for k in ("length_scale", "signal_variance"):
            np.testing.assert_allclose(tp["kernel"][k].grad.numpy(),
                                       np.asarray(wg[0]["kernel"][k]), rtol=2e-3, atol=1e-4)
        np.testing.assert_allclose(tp["log_beta"].grad.numpy(), np.asarray(wg[0]["log_beta"]),
                                   rtol=2e-3, atol=1e-4)
        assert (xt.grad == 0).all() and np.all(np.asarray(wg[1]) == 0)
        # dL/dy = Sigma^{-1} y: the two Grams differ by f32 rounding (direct
        # differences here, the quadratic expansion there), amplified by
        # cond(Sigma); 5e-4 is 1e-4 of max |dL/dy| ~ 7
        np.testing.assert_allclose(yt.grad.numpy(), np.asarray(wg[2]), rtol=1e-3, atol=5e-4)
