"""The port's Kronecker primitives (`fidelityfusion_tpu_torch/ops/kron.py`)
against the JAX package's `ops/kron.py` on the CPU, the same numpy inputs
through both.

Tolerances: mode products and the rank-1 assembly in float64 to 1e-12
(the same products in another order); the Kronecker NLML's value against
the dense NLML and against JAX in float64 to 1e-10, in float32 to rtol
1e-4 (two eigh implementations' rounding); the custom backward against
JAX's custom VJP in float64 to 1e-10 and against central differences to
1e-6 (the JAX package's own bar); the restart batch equal to per-restart
calls to 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidelityfusion_tpu.ops import kron as JK
from fidelityfusion_tpu_torch.ops import kron as TK


def _psd(rng, m):
    a = rng.standard_normal((m, m))
    return a @ a.T / m + np.eye(m)


def _problem(seed=0, shape=(7, 4, 3)):
    rng = np.random.default_rng(seed)
    Ks = [_psd(rng, d) for d in shape]
    y = rng.standard_normal(shape)
    return Ks, y, 0.3


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=grad)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_mode_dot_matches_jax(mode):
    rng = np.random.default_rng(mode)
    T = rng.standard_normal((5, 4, 3))
    M = rng.standard_normal((6, T.shape[mode]))
    with jax.enable_x64(True):
        want = np.asarray(JK.mode_dot(jnp.asarray(T), jnp.asarray(M), mode))
    got = TK.mode_dot(_t(T), _t(M), mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_batched_mode_dot_equals_per_restart(mode):
    """A (R, J, I) matrix over a (R, ...) tensor, and over a shared one
    (batch 1), equals R unbatched products; ``mode`` counts the batch axis."""
    rng = np.random.default_rng(10 + mode)
    T = rng.standard_normal((3, 5, 4, 3))
    M = rng.standard_normal((3, 2, T.shape[mode]))
    got = TK.mode_dot(_t(T), _t(M), mode).numpy()
    shared = TK.mode_dot(_t(T[:1]), _t(M), mode).numpy()
    for r in range(3):
        np.testing.assert_allclose(got[r], TK.mode_dot(_t(T[r]), _t(M[r]), mode - 1).numpy(),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(shared[r], TK.mode_dot(_t(T[0]), _t(M[r]), mode - 1).numpy(),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("modes", [None, (0, 2), (2, 1)])
def test_multi_mode_dot_matches_jax(modes):
    rng = np.random.default_rng(3)
    T = rng.standard_normal((5, 4, 3))
    use = modes if modes is not None else (0, 1, 2)
    Ms = [rng.standard_normal((2 + m, T.shape[m])) for m in use]
    with jax.enable_x64(True):
        want = np.asarray(JK.multi_mode_dot(jnp.asarray(T), [jnp.asarray(M) for M in Ms], modes))
    got = TK.multi_mode_dot(_t(T), [_t(M) for M in Ms], modes).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("batched", [False, True])
def test_rank1_tucker_matches_jax(batched):
    rng = np.random.default_rng(4)
    fs = [rng.standard_normal((2, d)) for d in (5, 4, 3)]
    with jax.enable_x64(True):
        want = [np.asarray(JK.rank1_tucker([jnp.asarray(f[r]) for f in fs])) for r in range(2)]
    if batched:
        got = TK.rank1_tucker([_t(f) for f in fs]).numpy()
        for r in range(2):
            np.testing.assert_allclose(got[r], want[r], rtol=1e-12)
    else:
        got = TK.rank1_tucker([_t(f[0]) for f in fs]).numpy()
        np.testing.assert_allclose(got, want[0], rtol=1e-12)


def test_clamp_psd_matches_jax_and_keeps_nan():
    lams = [np.array([-1e-3, 0.0, 2.0], np.float32), np.array([np.nan, -5.0, 1e-8], np.float32)]
    want = [np.asarray(a) for a in JK._clamp_psd([jnp.asarray(a) for a in lams])]
    got = [a.numpy() for a in TK._clamp_psd([torch.tensor(a) for a in lams])]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert np.isnan(got[1][0])


def test_kron_nlml_value_matches_dense_and_jax_in_float64():
    Ks, y, noise = _problem()
    Sigma = np.kron(np.kron(Ks[0], Ks[1]), Ks[2]) + noise * np.eye(y.size)
    yv = y.ravel()
    _, logdet = np.linalg.slogdet(Sigma)
    dense = 0.5 * (yv.size * np.log(2 * np.pi) + logdet + yv @ np.linalg.solve(Sigma, yv)) / yv.size
    with jax.enable_x64(True):
        jv = float(JK.kron_nlml(tuple(jnp.asarray(K) for K in Ks), jnp.asarray(y), noise))
    tv = TK.kron_nlml([_t(K) for K in Ks], _t(y), noise).item()
    np.testing.assert_allclose(tv, dense, rtol=1e-10)
    np.testing.assert_allclose(tv, jv, rtol=1e-10)


def test_kron_nlml_value_matches_jax_in_float32():
    Ks, y, noise = _problem(seed=1, shape=(24, 5, 6))
    jv = float(JK.kron_nlml(tuple(jnp.asarray(K, jnp.float32) for K in Ks),
                            jnp.asarray(y, jnp.float32), noise))
    tv = TK.kron_nlml([torch.tensor(K, dtype=torch.float32) for K in Ks],
                      torch.tensor(y, dtype=torch.float32), noise).item()
    np.testing.assert_allclose(tv, jv, rtol=1e-4)


def test_kron_nlml_backward_matches_jax_custom_vjp():
    Ks, y, noise = _problem(seed=2)
    with jax.enable_x64(True):
        jg = jax.grad(lambda *a: JK.kron_nlml(a[:3], a[3], a[4]), argnums=tuple(range(5)))(
            *(jnp.asarray(K) for K in Ks), jnp.asarray(y), jnp.asarray(noise))
    args = [_t(K, True) for K in Ks] + [_t(y, True), _t(noise, True)]
    TK.kron_nlml(args[:3], args[3], args[4]).backward()
    for g, a in zip(jg, args):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), rtol=1e-10, atol=1e-12)


def test_kron_nlml_backward_matches_finite_differences():
    Ks, y, noise = _problem(seed=3, shape=(5, 4))
    args = [_t(K, True) for K in Ks] + [_t(y, True), _t(noise, True)]
    TK.kron_nlml(args[:2], args[2], args[3]).backward()

    def f(vals):
        return TK.kron_nlml([_t(v) for v in vals[:2]], _t(vals[2]), _t(vals[3])).item()

    base = [np.array(K) for K in Ks] + [np.array(y), np.array(noise)]
    eps = 1e-6
    for k in range(4):
        g = args[k].grad.numpy()
        for idx in np.ndindex(base[k].shape):
            hi = [b.copy() for b in base]
            lo = [b.copy() for b in base]
            hi[k][idx] += eps
            lo[k][idx] -= eps
            assert abs((f(hi) - f(lo)) / (2 * eps) - g[idx]) < 1e-6, (k, idx)


def test_kron_nlml_restart_batch_equals_per_restart():
    """R = 3: batched mode Grams, targets and noise give the per-restart
    values and gradients; targets shared by the batch get the summed
    gradient."""
    rng = np.random.default_rng(5)
    R, shape = 3, (7, 4, 3)
    Ks = [np.stack([_psd(rng, d) for _ in range(R)]) for d in shape]
    y = rng.standard_normal((R,) + shape)
    noise = np.array([0.3, 0.2, 0.5])
    args = [_t(K, True) for K in Ks] + [_t(y, True), _t(noise, True)]
    vb = TK.kron_nlml(args[:3], args[3], args[4])
    vb.sum().backward()
    shared_y = _t(y[0], True)
    TK.kron_nlml([_t(K) for K in Ks], shared_y, _t(noise)).sum().backward()
    gy_shared = np.zeros(shape)
    for r in range(R):
        one = [_t(K[r], True) for K in Ks] + [_t(y[r], True), _t(noise[r], True)]
        v = TK.kron_nlml(one[:3], one[3], one[4])
        v.backward()
        np.testing.assert_allclose(vb[r].item(), v.item(), rtol=1e-12)
        for a, b in zip(args, one):
            np.testing.assert_allclose(a.grad.numpy()[r], b.grad.numpy(), rtol=1e-10, atol=1e-12)
        yr = _t(y[0], True)
        TK.kron_nlml([_t(K[r]) for K in Ks], yr, _t(noise[r])).backward()
        gy_shared += yr.grad.numpy()
    np.testing.assert_allclose(shared_y.grad.numpy(), gy_shared, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("where", ["K0", "K2", "noise"])
def test_kron_nlml_nan_isolation(where):
    """A non-finite entry in one restart's mode Gram (or noise) gives NaN
    for that restart only, with no exception from eigh, and finite
    gradients for the others."""
    rng = np.random.default_rng(6)
    R, shape = 4, (9, 4, 3)
    Ks = [np.stack([_psd(rng, d) for _ in range(R)]) for d in shape]
    noise = np.full(R, 0.3)
    if where == "noise":
        noise[2] = np.nan
    else:
        Ks[0 if where == "K0" else 2][2, 1, 0] = np.nan
    args = [_t(K, True) for K in Ks] + [_t(noise, True)]
    v = TK.kron_nlml(args[:3], _t(rng.standard_normal(shape)), args[3])
    v.sum().backward()
    assert np.isnan(v[2].item()) and np.isfinite(v[[0, 1, 3]].detach().numpy()).all()
    for a in args:
        assert np.isfinite(a.grad.numpy()[[0, 1, 3]]).all()


def test_eigh_pairs_matches_eigh_and_flags_nonfinite():
    rng = np.random.default_rng(7)
    K = np.stack([_psd(rng, 6) for _ in range(3)])
    K[1, 2, 3] = np.inf
    w, V = TK.eigh_pairs(_t(K))
    w0, _ = np.linalg.eigh(K[0])
    np.testing.assert_allclose(w[0].numpy(), w0, rtol=1e-12)
    assert np.isnan(w[1].numpy()).all() and np.isfinite(w[[0, 2]].numpy()).all()
    np.testing.assert_array_equal(V[1].numpy(), np.eye(6))
