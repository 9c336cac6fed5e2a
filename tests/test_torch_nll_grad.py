"""K4, the NLML's Sigma gradient (`ops/linalg.py:sigma_grad`,
`csrc/nll_grad.cu`): its tile walk on the CPU, its routing, and the kernel
on the card.

The CPU tests hold a plain twin of K4's walk (`_tiled`: output tiles on or
below the diagonal, each one's K chain from its own row tile on, W's
entries above the diagonal never used) against the one-expression
`sigma_grad_plain`.  The tests marked ``cuda`` skip where there is no CUDA
device (decided inside the fixture, never at import).  Run them on a card:

    python -m pytest tests/test_torch_nll_grad.py -q -m cuda

Tolerances are the worst-case rounding bound of the two sums, whatever
their order: |fl(sum) - sum| <= gamma_m sum |terms|, gamma_m = m u / (1 - m u),
with m the terms summed plus the few roundings after them (d times, the
subtraction, the scale) and u the unit roundoff of the working type.
"""

import numpy as np
import pytest
import torch

from fidelityfusion_tpu_torch.ops import linalg

TILE = 128  # K4's output tile at (4, 4096); 64 where fewer items than SMs (`csrc/nll_grad.cu`)


def _tiled(W, alpha, g, tile=TILE):
    """K4's walk in plain PyTorch."""
    n, d = W.shape[-1], alpha.shape[-1]
    W3, a3 = W.reshape((-1, n, n)), alpha.reshape((-1, n, d))
    s = (0.5 * g).reshape(-1).expand(W3.shape[0])[:, None, None]
    idx = torch.arange(n)
    spans = [(t, min(n, t + tile)) for t in range(0, n, tile)]

    def part(k, c):  # W[k rows, c columns], its entries above the diagonal not used
        keep = idx[k[0]:k[1], None] >= idx[None, c[0]:c[1]]
        return torch.where(keep, W3[:, k[0]:k[1], c[0]:c[1]], torch.zeros((), dtype=W.dtype))

    out = W3.new_empty(W3.shape)
    for I, (i0, i1) in enumerate(spans):
        for j0, j1 in spans[:I + 1]:
            acc = sum(part(k, (i0, i1)).transpose(1, 2) @ part(k, (j0, j1)) for k in spans[I:])
            v = s * (d * acc - a3[:, i0:i1] @ a3[:, j0:j1].transpose(1, 2))
            out[:, i0:i1, j0:j1] = v
            out[:, j0:j1, i0:i1] = v.transpose(1, 2)
    return out.reshape(W.shape)


def _bound(W, alpha, g, unit):
    """The rounding bound above, in float64, for one side against the exact value."""
    W, alpha, g = W.double().tril(), alpha.double(), g.double()
    n, d = W.shape[-1], alpha.shape[-1]

    def gamma(m):
        return m * unit / (1 - m * unit)

    aW, aa = W.abs(), alpha.abs()
    return (0.5 * g.abs())[..., None, None] * (
        d * gamma(n + 3) * (aW.transpose(-1, -2) @ aW)
        + gamma(d + 3) * (aa @ aa.transpose(-1, -2)))


def _problem(B, n, d, dtype, seed=0):
    """A well-conditioned lower-triangular W, alpha and g; B = 1 unbatched."""
    r = np.random.default_rng(seed)
    shape = (n, n) if B == 1 else (B, n, n)
    diag = 1.0 + r.random(shape[:-1])
    W = np.tril(r.standard_normal(shape)) / np.sqrt(n) + np.eye(n) * diag[..., None]
    alpha = r.standard_normal(shape[:-1] + (d,))
    g = 0.5 + r.random(shape[:-2])
    return (torch.as_tensor(W, dtype=dtype), torch.as_tensor(alpha, dtype=dtype),
            torch.as_tensor(g, dtype=dtype))


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("n", [64, 320, 1000, 1024])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_tiled_walk_matches_plain(dtype, n, B, d):
    """Lower-triangle tiles with their mirrors, K chains from the row tile
    on, a ragged last tile at n = 1000, against the plain expression; both
    sides' rounding bounds together."""
    W, alpha, g = _problem(B, n, d, dtype)
    got, want = _tiled(W, alpha, g), linalg.sigma_grad_plain(W, alpha, g)
    assert got.shape == want.shape == W.shape
    unit = torch.finfo(dtype).eps / 2
    assert bool(((got - want).abs() <= 2 * _bound(W, alpha, g, unit).to(dtype)).all())
    # dSigma is symmetric exactly: each mirror is a copy
    assert torch.equal(got, got.transpose(-1, -2))


@pytest.mark.parametrize("tile", [128, 64])
def test_tiled_walk_never_reads_above_the_diagonal(tile):
    """W's entries above the diagonal, and so every tile above it, are NaN:
    the walk at either tile width comes out finite and equal to the plain
    expression on tril(W)."""
    W, alpha, g = _problem(4, 1000, 2, torch.float64, seed=1)
    upper = torch.ones(1000, 1000, dtype=torch.bool).triu(1)
    Wn = torch.where(upper, torch.full((), float("nan"), dtype=W.dtype), W)
    got = _tiled(Wn, alpha, g, tile)
    assert bool(torch.isfinite(got).all())
    want = linalg.sigma_grad_plain(W, alpha, g)
    assert bool(((got - want).abs() <= 2 * _bound(W, alpha, g, 2.0 ** -53)).all())


def test_sigma_grad_on_cpu_is_the_plain_expression():
    W, alpha, g = _problem(4, 320, 1, torch.float32)
    assert torch.equal(linalg.sigma_grad(W, alpha, g), linalg.sigma_grad_plain(W, alpha, g))


def _small_ar(device):
    """A 3-fidelity AR on nested 384/320/128-row toy data: two stages of
    >= `NLL_GRAD_MIN_N` rows and one below."""
    from fidelityfusion_tpu_torch.demo import _toy_3fid
    from fidelityfusion_tpu_torch.models.ar import AR
    from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager
    from fidelityfusion_tpu_torch.ops.kernels import SquaredExponentialKernel

    xs, ys, _, _ = _toy_3fid(seed=1, sizes=(384, 320, 128), pool=512, n_test=8, nested=True)
    dm = MultiFidelityDataManager([
        {"raw_fidelity_name": str(i), "fidelity_indicator": i, "X": x, "Y": y}
        for i, (x, y) in enumerate(zip(xs, ys))])
    return AR(3, [SquaredExponentialKernel() for _ in range(3)], input_dim=1, device=device), dm


STEPS = 3


def test_restart_fit_routes_large_stages_to_k4(monkeypatch):
    """`_MvnNll.backward` takes `sigma_grad` once a step in each stage of
    >= `NLL_GRAD_MIN_N` rows, on W of the stage's own rows (384 and 320,
    both multiples of the 64-row panel), and `sigma_grad_plain` in the
    others."""
    from fidelityfusion_tpu_torch.models.ar import train_AR

    rows = []
    real = linalg.sigma_grad

    def counted(W, alpha, g):
        rows.append(W.shape[-1])
        return real(W, alpha, g)

    monkeypatch.setattr(linalg, "sigma_grad", counted)
    model, dm = _small_ar("cpu")
    train_AR(model, dm, max_iter=STEPS, lr_init=5e-2, n_restarts=2)
    assert sorted(rows) == [320] * STEPS + [384] * STEPS


# ---- on the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _se_inverse(dev, B, n, seed=0):
    """W = inv(L) of B SE Grams (noise 1e-2) from the port's factorization,
    and alpha = W^T W y, g: the backward's inputs as the NLML makes them."""
    from fidelityfusion_tpu_torch.ops.chol import chol_inv_padded
    from fidelityfusion_tpu_torch.ops.gram import gram_plain

    gen = torch.Generator().manual_seed(seed)
    x = (4.0 * torch.rand((n, 2), generator=gen)).to(dev)
    inv_ls = torch.linspace(0.6, 3.0, B)[:, None].expand(B, 2).contiguous().to(dev)
    Sigma = gram_plain(x, x, inv_ls, torch.ones(B, device=dev), torch.full((B,), 1e-2, device=dev))
    _, W = chol_inv_padded(Sigma)
    y = torch.sin(3.0 * x[:, :1]).expand(B, n, 1)
    alpha = W.transpose(1, 2) @ (W @ y)
    g = torch.tensor([1.0, 0.5, 2.0, -1.0][:B], device=dev)
    return W, alpha, g


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,cropped", [(4, 4096, False), (4, 1024, False), (1, 320, False),
                                         (1, 1000, True)])
def test_k4_matches_float64(dev, B, n, cropped):
    """K4 against the plain expression in float64 on the same float32 W,
    alpha and g, within the float32 rounding bound (module docstring).
    ``cropped``: W is the 1000-row view of a 1024-row buffer whose padding
    and upper triangle hold NaN, so a read past n or above the diagonal
    would show."""
    W, alpha, g = _se_inverse(dev, B, n)
    if cropped:
        buf = torch.full((B, 1024, 1024), float("nan"), device=dev)
        upper = torch.ones(n, n, dtype=torch.bool, device=dev).triu(1)
        buf[:, :n, :n] = torch.where(upper, float("nan"), W)
        W = buf[:, :n, :n]
    before = linalg.NLL_GRAD_LAUNCHES.launches
    got = linalg.sigma_grad(W, alpha, g)
    torch.cuda.synchronize()
    assert linalg.NLL_GRAD_LAUNCHES.launches == before + 1
    Wc = W.nan_to_num().tril()
    want = linalg.sigma_grad_plain(Wc.double(), alpha.double(), g.double())
    assert bool(torch.isfinite(got).all())
    assert bool(((got.double() - want).abs() <= _bound(Wc, alpha, g, 2.0 ** -24)).all())


@pytest.mark.cuda
def test_mvn_nll_batched_grad_matches_float64_autodiff(dev):
    """`mvn_nll`'s Sigma and y gradients on the card (K3a, K3b, K4 at 4
    restarts of 640 rows) against autodiff of
    `mvn_nll(method="direct")` in float64 on the CPU.  Noise 0.1 keeps
    cond(Sigma) near 1e4, where the float32 factorization's own error is
    about 1e-4 of the gradient's scale."""
    from fidelityfusion_tpu_torch.ops.gram import gram_plain

    B, n = 4, 640
    gen = torch.Generator().manual_seed(3)
    x = 4.0 * torch.rand((n, 2), generator=gen, dtype=torch.float64)
    inv_ls = torch.linspace(0.6, 3.0, B, dtype=torch.float64)[:, None].expand(B, 2).contiguous()
    S64 = gram_plain(x, x, inv_ls, torch.ones(B, dtype=torch.float64),
                     torch.full((B,), 0.1, dtype=torch.float64))
    y64 = torch.sin(3.0 * x[:, :1]) + 0.1 * torch.randn((n, 1), generator=gen, dtype=torch.float64)
    S, y = S64.float().to(dev).requires_grad_(), y64.float().to(dev).requires_grad_()
    before = linalg.NLL_GRAD_LAUNCHES.launches
    gS, gy = torch.autograd.grad(linalg.mvn_nll(S, y).sum(), (S, y))
    assert linalg.NLL_GRAD_LAUNCHES.launches == before + 1
    S64.requires_grad_()
    y64.requires_grad_()
    rS, ry = torch.autograd.grad(linalg.mvn_nll(S64, y64, method="direct").sum(), (S64, y64))
    for got, want in ((gS, rS), (gy, ry)):
        err = (got.cpu().double() - want).abs().max().item()
        assert err <= 2e-3 * want.abs().max().item(), err


@pytest.mark.cuda
def test_k4_launches_once_a_step_per_large_stage(dev):
    """K4 launches steps x (stages of >= 320 rows) times in a restart fit."""
    from fidelityfusion_tpu_torch.models.ar import train_AR

    model, dm = _small_ar(dev)
    before = linalg.NLL_GRAD_LAUNCHES.launches
    train_AR(model, dm, max_iter=STEPS, lr_init=5e-2, n_restarts=2)
    torch.cuda.synchronize()
    assert linalg.NLL_GRAD_LAUNCHES.launches - before == 2 * STEPS
