"""K2/K3a's and K3b's plain versions as the kernels compute them: the
recursive 64 -> 32 leaf (`_leaf_chol_inv_rec`) against the flat rank-1
leaf and the JAX leaf, `chol_inv_plain` against the JAX blocked
factorizations, and the halving `tri_inv_plain` against the row
recurrence, `_tri_inv_assemble` and the retired Pallas inverse, in float64
where exactness is the question and in float32 at the bars of
tests/test_torch_blocked.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.retired.pallas_batched import _tri_inv_recursive, tri_inv_vmem
from fidelityfusion_tpu.ops import blocked as JB
from fidelityfusion_tpu_torch.ops.chol import (
    PANEL, _leaf_chol_inv, _leaf_chol_inv_rec, chol_inv, chol_inv_plain, chol_leaf, tri_inv,
    tri_inv_plain)


def _spd(rng, n, R):
    A = rng.standard_normal((R, n, n))
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _se_blocks(rng, R):
    """(R, 64, 64) SE Grams at noise 1e-2 on sorted inputs, length scales
    from 0.1 to 1, as the diagonal blocks of the slice's Grams are."""
    x = np.sort(rng.standard_normal(PANEL))
    ls = np.linspace(0.1, 1.0, R)[:, None, None]
    return np.exp(-0.5 * ((x[:, None] - x[None, :]) / ls) ** 2) + 1e-2 * np.eye(PANEL)


LEAF_INPUTS = {"random": lambda rng: _spd(rng, PANEL, 4), "se": lambda rng: _se_blocks(rng, 4)}


@pytest.mark.parametrize("kind", sorted(LEAF_INPUTS))
def test_recursive_leaf_matches_flat_leaf_f64(kind):
    """L and W of the 2x2 recursion equal the flat sweep's to 1e-12 relative."""
    S = torch.tensor(LEAF_INPUTS[kind](np.random.default_rng(8)))
    L, W = _leaf_chol_inv_rec(S)
    Lf, Wf = _leaf_chol_inv(S)
    assert _rel(L.numpy(), Lf.numpy()) <= 1e-12
    assert _rel(W.numpy(), Wf.numpy()) <= 1e-12
    assert (torch.triu(L, 1) == 0).all() and (torch.triu(W, 1) == 0).all()
    np.testing.assert_allclose((W @ L).numpy(), np.broadcast_to(np.eye(PANEL), W.shape),
                               atol=1e-13)


def test_recursive_leaf_matches_jax_leaf_f32():
    S = _spd(np.random.default_rng(7), PANEL, 3).astype(np.float32)
    wL, wW = (np.asarray(a) for a in jax.vmap(JB._leaf_chol_inv)(jnp.asarray(S)))
    L, W = chol_leaf(torch.tensor(S))  # CPU tensors: the plain recursive leaf
    np.testing.assert_allclose(L.numpy(), wL, rtol=1e-4, atol=1e-4 * np.abs(wL).max())
    np.testing.assert_allclose(W.numpy(), wW, rtol=1e-3, atol=1e-4 * np.abs(wW).max())
    with pytest.raises(ValueError, match="expected"):
        chol_leaf(torch.eye(PANEL))


def test_chol_inv_plain_n192_f64_and_f32():
    """n = 192 (three panels): float64 against numpy and the JAX fused-leaf
    blocked factorization, float32 against the latter."""
    S = _spd(np.random.default_rng(11), 192, 1)[0]
    L, Wd = chol_inv_plain(torch.tensor(S)[None])
    np.testing.assert_allclose(L[0].numpy(), np.linalg.cholesky(S), rtol=1e-12, atol=1e-12)
    with jax.enable_x64(True):
        jL, jW = jax.jit(lambda a: JB.blocked_chol_inv(a, block=64, precision="highest"))(
            jnp.asarray(S))
        jL, jW = np.asarray(jL), np.asarray(jW)
    assert _rel(L[0].numpy(), jL) <= 1e-12
    for k in range(3):
        blk = slice(64 * k, 64 * (k + 1))
        assert _rel(Wd[0, k].numpy(), jW[blk, blk]) <= 1e-12
    S32 = S.astype(np.float32)
    jL32 = np.asarray(JB.blocked_chol_inv(jnp.asarray(S32), block=64, precision="highest")[0])
    L32, _ = chol_inv_plain(torch.tensor(S32)[None])
    np.testing.assert_allclose(L32[0].numpy(), jL32, rtol=1e-4, atol=1e-4 * np.abs(jL32).max())


def test_chol_inv_plain_batch_matches_jax_v2_and_isolates_nan():
    """(R = 3, n = 256) against `vmap(blocked_chol_inv_v2(leaf="fused"))` in
    float32; then one indefinite matrix of the batch gives NaN in its own
    factor only."""
    S = _spd(np.random.default_rng(12), 256, 3).astype(np.float32)
    v2 = jax.jit(jax.vmap(lambda a: JB.blocked_chol_inv_v2(
        a, block=64, precision="highest", leaf="fused")))
    wL, wW = (np.asarray(a) for a in v2(jnp.asarray(S)))
    L, Wd = chol_inv(torch.tensor(S))
    np.testing.assert_allclose(L.numpy(), wL, rtol=1e-4, atol=1e-4 * np.abs(wL).max())
    for k in range(4):
        blk = slice(64 * k, 64 * (k + 1))
        np.testing.assert_allclose(Wd[:, k].numpy(), wW[:, blk, blk], rtol=1e-3,
                                   atol=1e-4 * np.abs(wW).max())
    S[1, 150, 150] = -1.0  # a negative pivot in panel 2 of matrix 1
    L, Wd = chol_inv_plain(torch.tensor(S))
    assert torch.isnan(L[1, 150:, 150]).all() and torch.isnan(Wd[1, 2:]).any()
    assert torch.isfinite(L[1, :128]).all() and torch.isfinite(L[[0, 2]]).all()
    np.testing.assert_allclose(L[[0, 2]].numpy(), wL[[0, 2]], rtol=1e-4,
                               atol=1e-4 * np.abs(wL).max())


def _tri_inv_rows(L, Wd):
    """The row-block recurrence K3b computed before its level-by-level form:
    W[k,k] = W_kk, W[k,:k] = -W_kk (L[k,:k] W[:k,:k])."""
    W = torch.zeros_like(L)
    for k in range(L.shape[-1] // PANEL):
        s, e = k * PANEL, (k + 1) * PANEL
        W[:, s:e, s:e] = Wd[:, k]
        W[:, s:e, :s] = -(Wd[:, k] @ (L[:, s:e, :s] @ W[:, :s, :s]))
    return W


def _factor(n, R, dtype):
    """(L, Wd) of R random SPD matrices of size n by the plain K2/K3a."""
    return chol_inv_plain(torch.tensor(_spd(np.random.default_rng(n + R), n, R)).to(dtype))


TRI_SHAPES = [(nb, R) for nb in (3, 5, 6, 8) for R in (1, 3)]


@pytest.mark.parametrize("nb,R", TRI_SHAPES)
def test_tri_inv_plain_matches_rows_and_assemble_f64(nb, R):
    """nb = 3, 5, 6, 8 blocks (unequal halves at some level for all but 8):
    equal to the row recurrence and to the JAX `_tri_inv_assemble` to
    1e-12 relative, Wd on the diagonal and zeros above it exactly."""
    n = nb * PANEL
    L, Wd = _factor(n, R, torch.float64)
    W = tri_inv_plain(L, Wd)
    assert _rel(W.numpy(), _tri_inv_rows(L, Wd).numpy()) <= 1e-12
    with jax.enable_x64(True):
        want = np.stack([np.asarray(JB._tri_inv_assemble(
            jnp.asarray(L[r].numpy()), [jnp.asarray(w) for w in Wd[r].numpy()], PANEL,
            precision="highest")) for r in range(R)])
    assert _rel(W.numpy(), want) <= 1e-12
    assert (torch.triu(W, 1) == 0).all()
    for k in range(nb):
        blk = slice(k * PANEL, (k + 1) * PANEL)
        assert torch.equal(W[:, blk, blk], Wd[:, k])


@pytest.mark.parametrize("nb,R", TRI_SHAPES)
def test_tri_inv_plain_matches_jax_and_pallas_f32(nb, R):
    """float32 against the JAX `_tri_inv_recursive` and the retired
    `tri_inv_vmem` in interpret mode, at the bars of
    tests/test_torch_blocked.py:test_chol_and_tri_inv_plain_match_pallas_batched;
    the CPU wrapper runs the plain version."""
    n = nb * PANEL
    L, Wd = _factor(n, R, torch.float32)
    W = tri_inv(L, Wd)
    np.testing.assert_array_equal(W.numpy(), tri_inv_plain(L, Wd).numpy())
    jL = jnp.asarray(L.numpy())
    for want in (np.asarray(jax.jit(jax.vmap(_tri_inv_recursive))(jL)),
                 np.asarray(jax.vmap(lambda a: tri_inv_vmem(a, block=PANEL, interpret=True))(jL))):
        np.testing.assert_allclose(W.numpy(), want, rtol=1e-3, atol=1e-4 * np.abs(want).max())


def test_tri_inv_plain_isolates_nan():
    """A NaN in matrix 1's L and one in matrix 2's Wd: NaN in those W only,
    the others as computed alone."""
    L, Wd = _factor(384, 4, torch.float32)
    L[1, 200, 70] = float("nan")
    Wd[2, 1, 5, 3] = float("nan")
    W = tri_inv_plain(L, Wd)
    assert torch.isnan(W[1]).any() and torch.isnan(W[2]).any()
    assert torch.isfinite(W[[0, 3]]).all()
    np.testing.assert_array_equal(W[[0, 3]].numpy(), tri_inv_plain(L[[0, 3]], Wd[[0, 3]]).numpy())
