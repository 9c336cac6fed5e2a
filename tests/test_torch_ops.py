"""The port's kernels module and K1's plain version against the JAX package
and the retired Pallas Gram (interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.retired.pallas_gram import gram_se
from fidelityfusion_tpu.ops import kernels as JK
from fidelityfusion_tpu.train.fit import gp_restart_batch as jax_gp_restart_batch
from fidelityfusion_tpu_torch.ops import kernels as TK
from fidelityfusion_tpu_torch.ops.gram import _gram_cuda, gram, gram_plain
from fidelityfusion_tpu_torch.train import fit as TF

KERNELS = [
    ("se", JK.SquaredExponentialKernel(), TK.SquaredExponentialKernel(),
     {"length_scale": [0.3], "signal_variance": [-0.2]}),
    ("ard", JK.ARDKernel(), TK.ARDKernel(),
     {"length_scales": [0.7, -1.3, 2.1], "signal_variance": [1.7]}),
]


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def test_sq_dist_matches_jax():
    rng = np.random.default_rng(0)
    x1, x2 = rng.standard_normal((40, 3)) * 5, rng.standard_normal((30, 3)) * 5
    with jax.enable_x64(True):
        want = np.asarray(jax.jit(JK.sq_dist)(jnp.asarray(x1), jnp.asarray(x2)))
    got = TK.sq_dist(_t(x1), _t(x2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    want32 = np.asarray(jax.jit(JK.sq_dist)(jnp.asarray(x1, jnp.float32),
                                            jnp.asarray(x2, jnp.float32)))
    got32 = TK.sq_dist(_t(x1, torch.float32), _t(x2, torch.float32)).numpy()
    np.testing.assert_allclose(got32, want32, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("name,jspec,tspec,raw", KERNELS, ids=[k[0] for k in KERNELS])
def test_gram_and_grad_match_jax_f64(name, jspec, tspec, raw):
    """Values and parameter gradients of <G, K(x1, x2)> in float64."""
    rng = np.random.default_rng(1)
    x1, x2 = rng.standard_normal((33, 3)), rng.standard_normal((21, 3))
    G = rng.standard_normal((33, 21))
    with jax.enable_x64(True):
        jp = {k: jnp.asarray(v, jnp.float64) for k, v in raw.items()}
        K_of = jax.jit(lambda p: jspec.apply(p, jnp.asarray(x1), jnp.asarray(x2)))
        want_g = jax.jit(jax.grad(lambda p: jnp.sum(K_of(p) * G)))(jp)
        want_K = np.asarray(K_of(jp))
    tp = {k: _t(v).requires_grad_() for k, v in raw.items()}
    K = tspec(tp, _t(x1), _t(x2))
    np.testing.assert_allclose(K.detach().numpy(), want_K, rtol=1e-9, atol=1e-12)
    (K * _t(G)).sum().backward()
    for k in raw:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(want_g[k]), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("name,jspec,tspec,raw", KERNELS, ids=[k[0] for k in KERNELS])
def test_gram_f32_matches_jax(name, jspec, tspec, raw):
    rng = np.random.default_rng(2)
    x = rng.random((64, 3)) * 4
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in raw.items()}
    want = np.asarray(jax.jit(jspec.apply)(jp, jnp.asarray(x, jnp.float32),
                                           jnp.asarray(x, jnp.float32)))
    tp = {k: _t(v, torch.float32) for k, v in raw.items()}
    got = tspec(tp, _t(x, torch.float32), _t(x, torch.float32)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_gram_input_and_diag_gradients_f64():
    """x1, x2, diag_add and y_var gradients of K1 against autograd through
    an independent dense formula."""
    rng = np.random.default_rng(3)
    x1 = _t(rng.standard_normal((9, 2))).requires_grad_()
    x2 = _t(rng.standard_normal((7, 2))).requires_grad_()
    inv_ls = _t(rng.random((3, 2)) + 0.5).requires_grad_()
    sv = _t(rng.random(3) + 0.5).requires_grad_()
    da = _t(rng.random(3)).requires_grad_()
    yv = _t(rng.random((3, 9))).requires_grad_()
    G = _t(rng.standard_normal((3, 9, 7)))
    args = (x1, x2, inv_ls, sv, da, yv)
    (gram(*args[:4], diag_add=da, y_var=yv) * G).sum().backward()
    got = [a.grad.clone() for a in args]
    for a in args:
        a.grad = None
    diff = (x1[None, :, None, :] - x2[None, None, :, :]) * inv_ls[:, None, None, :]
    K = sv[:, None, None] * torch.exp(-0.5 * (diff ** 2).sum(-1))
    eye = torch.eye(9, 7, dtype=torch.float64)
    K = K + eye * (da[:, None, None] + yv[:, :, None])
    (K * G).sum().backward()
    for g, a in zip(got, args):
        np.testing.assert_allclose(g.numpy(), a.grad.numpy(), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("square", [False, True], ids=["cross", "square_with_diag"])
def test_gram_backward_gradcheck_f64(square):
    """K1's hand-written backward (exp(-d2/2) from `gram_plain` on the CPU,
    from the kernel on the card) against `torch.autograd.gradcheck`'s
    finite differences in float64, in x1, x2, the inverse length scales and
    sv (and, square, the diagonal terms); the gradient also equals autograd
    through `gram_plain` to 1e-12."""
    rng = np.random.default_rng(11)
    n1, n2 = (6, 6) if square else (5, 7)
    x1 = _t(rng.standard_normal((n1, 2))).requires_grad_()
    x2 = x1 if square else _t(rng.standard_normal((n2, 2))).requires_grad_()
    inv_ls = _t(rng.random((2, 2)) + 0.5).requires_grad_()
    sv = _t(rng.random(2) + 0.5).requires_grad_()
    extra = ((_t(rng.random(2)).requires_grad_(), _t(rng.random((2, n1))).requires_grad_())
             if square else ())
    inputs = (x1, inv_ls, sv) + extra if square else (x1, x2, inv_ls, sv)

    def f(*a):
        if square:
            return gram(a[0], a[0], a[1], a[2], diag_add=a[3], y_var=a[4])
        return gram(*a)

    assert torch.autograd.gradcheck(f, inputs, eps=1e-6, atol=1e-8, rtol=1e-6)
    G = _t(rng.standard_normal((2, n1, n2)))
    got = torch.autograd.grad((f(*inputs) * G).sum(), inputs)
    want = torch.autograd.grad((gram_plain(x1, x2, inv_ls, sv, *extra) * G).sum(), inputs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10, atol=1e-12)


def test_gram_plain_matches_retired_pallas_gram():
    """K1's plain version against `pallas_gram.gram_se` in interpret mode
    (n = 256, block 128; the tests/test_pallas.py bars)."""
    rng = np.random.default_rng(4)
    n, d = 256, 4
    x = rng.random((n, d)).astype(np.float32)
    ls = np.asarray([0.5, 1.0, 2.0, 0.8], np.float32)
    sv, da = 1.3, 0.123
    want = np.asarray(gram_se(jnp.asarray(x / ls), jnp.asarray(x / ls), jnp.asarray(sv),
                              diag_add=da, block=128, interpret=True))
    got = gram_plain(_t(x, torch.float32), _t(x, torch.float32), _t(1 / ls, torch.float32)[None],
                     torch.tensor([sv]), torch.tensor([da]))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_gram_near_duplicate_rows():
    """Large-norm near-duplicate rows: finite, K <= sv, diag exactly sv."""
    rng = np.random.default_rng(3)
    base = rng.random((64, 4)).astype(np.float32) * 100.0
    x = _t(np.concatenate([base, base + 1e-4, base - 1e-4, base * (1 + 1e-6)]), torch.float32)
    K = gram_plain(x, x, torch.ones((1, 4)), torch.tensor([2.0]))[0]
    assert torch.isfinite(K).all()
    assert K.max() <= 2.0 + 1e-4
    assert (K.diagonal() == 2.0).all()


def test_gram_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros((4, 1))
    with pytest.raises(ValueError, match="CUDA"):
        _gram_cuda(x, x, torch.ones((1, 1)), torch.ones(1), None, None)


@pytest.mark.parametrize("n", [5, 255, 256, 257, 1000, 2048])
def test_median_heuristic_matches_jax(n):
    """Even counts average the two middle values; rows above 256 are
    subsampled exactly as `jnp.linspace(...).astype(int32)` picks them."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((n, 2)) * [1.0, 3.0]).astype(np.float32)
    want = np.asarray(jax.jit(JK.median_heuristic)(jnp.asarray(x)))
    got = TK.median_heuristic(_t(x, torch.float32)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("name,jspec,tspec,raw", KERNELS, ids=[k[0] for k in KERNELS])
def test_restart_ladder_matches_jax(name, jspec, tspec, raw):
    rng = np.random.default_rng(5)
    d = len(raw.get("length_scales", [0]))
    x = rng.standard_normal((300, d)).astype(np.float32)
    jp = {"kernel": {k: jnp.asarray(v, jnp.float32) for k, v in raw.items()},
          "log_beta": jnp.asarray([1.0], jnp.float32)}
    tp = {"kernel": {k: _t(v, torch.float32) for k, v in raw.items()},
          "log_beta": torch.tensor([1.0])}
    want = jax_gp_restart_batch(jspec, jp, jnp.asarray(x), 8, jax.random.PRNGKey(0))
    got = TF.gp_restart_batch(tspec, tp, _t(x, torch.float32), 8)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g["log_beta"].numpy(), np.asarray(w["log_beta"]))
        for k in raw:
            np.testing.assert_allclose(g["kernel"][k].numpy(), np.asarray(w["kernel"][k]),
                                       rtol=1e-6)


def test_trainable_mask_matches_jax():
    params = {"a": np.zeros(2), "_z": (np.zeros(3), np.zeros(1)), "k": {"_c": np.zeros(1), "b": 1}}
    assert TK.trainable_mask(None, params) == {"a": True, "_z": (False, False),
                                               "k": {"_c": False, "b": True}}
    jm = JK.trainable_mask(None, params)
    assert jm["a"] and not jm["_z"][0] and not jm["k"]["_c"] and jm["k"]["b"]
