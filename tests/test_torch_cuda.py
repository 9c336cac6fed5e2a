"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``; each test skips where there is no CUDA device (the
decision is taken inside the fixture, never at import).  Run on a card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _spd(dev, R, n):
    from fidelityfusion_tpu_torch.ops.gram import gram_plain

    g = torch.Generator().manual_seed(n)
    x = torch.randn((n, 1), generator=g).to(dev)
    inv_ls = torch.linspace(0.6, 4.0, R, device=dev)[:, None].contiguous()
    return gram_plain(x, x, inv_ls, torch.ones(R, device=dev), torch.full((R,), 1e-2, device=dev))


@pytest.mark.parametrize("n1,n2,d", [(256, 256, 1), (100, 37, 3), (64, 200, 40), (256, 256, 2),
                                     (96, 96, 3), (1024, 1000, 1), (130, 1001, 1), (37, 300, 2),
                                     (200, 200, 8), (96, 96, 9), (64, 64, 40)])
def test_gram_kernel_matches_plain(dev, n1, n2, d):
    """d = 1 and 2 take the register path, every other d the chunked one; ragged
    n1 and n2, n2 not a multiple of 4 (scalar stores), nugget and y_var
    on square Grams."""
    from fidelityfusion_tpu_torch.ops.gram import gram, gram_plain

    g = torch.Generator().manual_seed(0)
    x1, x2 = torch.randn((n1, d), generator=g).to(dev), torch.randn((n2, d), generator=g).to(dev)
    inv_ls = (torch.rand((3, d), generator=g) + 0.5).to(dev)
    sv = torch.tensor([0.5, 1.0, 2.0], device=dev)
    da = torch.tensor([1e-2, 1e-3, 0.1], device=dev) if n1 == n2 else None
    yv = torch.rand((3, n1), generator=g).to(dev) if n1 == n2 else None
    got = gram(x1, x2, inv_ls, sv, diag_add=da, y_var=yv)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, gram_plain(x1, x2, inv_ls, sv, da, yv), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n1,n2,d", [(1024, 1024, 4), (32, 32, 1), (130, 77, 2), (96, 96, 3)])
def test_gram_kernel_float64_matches_plain(dev, n1, n2, d):
    """K1's float64 instance (the Kronecker path's Grams): register path
    (d = 1, 2, 4) and chunked path (d = 3), ragged shapes, the nugget on
    square Grams, against the plain version in float64; its backward too."""
    from fidelityfusion_tpu_torch.ops.gram import gram, gram_plain

    f64 = torch.float64
    g = torch.Generator().manual_seed(1)
    x1 = torch.rand((n1, d), generator=g, dtype=f64).to(dev)
    x2 = x1 if n1 == n2 else torch.rand((n2, d), generator=g, dtype=f64).to(dev)
    inv_ls = (torch.rand((2, d), generator=g, dtype=f64) + 0.5).to(dev).requires_grad_()
    sv = torch.tensor([0.7, 1.3], dtype=f64, device=dev).requires_grad_()
    da = torch.tensor([1e-6, 1e-3], dtype=f64, device=dev) if n1 == n2 else None
    got = gram(x1, x2, inv_ls, sv, diag_add=da)
    want = gram_plain(x1, x2, inv_ls, sv, da)
    assert got.dtype == f64
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-15)
    G = torch.randn(got.shape, generator=g, dtype=f64).to(dev)
    for a, b in zip(torch.autograd.grad((got * G).sum(), (inv_ls, sv)),
                    torch.autograd.grad((want * G).sum(), (inv_ls, sv))):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def test_gram_kernel_at_nar_stage_shape(dev):
    """NAR's stage-1 training Gram: 4 restarts, n = 512, d = 2 ([x, y_low]),
    nugget and y_var, on the register path; the diagonal is exact."""
    from fidelityfusion_tpu_torch.ops.gram import gram, gram_plain

    g = torch.Generator().manual_seed(2)
    x = torch.randn((512, 2), generator=g).to(dev)
    inv_ls = (torch.rand((4, 2), generator=g) + 0.5).to(dev)
    sv = torch.tensor([0.5, 1.0, 1.5, 2.0], device=dev)
    da = torch.tensor([1e-2, 1e-3, 0.1, 1e-4], device=dev)
    yv = torch.rand((4, 512), generator=g).to(dev)
    got = gram(x, x, inv_ls, sv, diag_add=da, y_var=yv)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, gram_plain(x, x, inv_ls, sv, da, yv), rtol=1e-4, atol=1e-5)
    assert (got.diagonal(dim1=1, dim2=2) == sv[:, None] + da[:, None] + yv).all()


def test_gram_kernel_at_kronecker_shape_with_dim1_length_scale(dev):
    """The HOGP K_0 of the Kronecker path: 4 restarts, n = 1024, d = 4 (the
    Poisson source parameters) on the register path, one ARD length scale
    per restart broadcast over the four inputs, the jitter nugget and
    y_var; the diagonal exact; the scale's gradient the sum over d of the
    repeated scale's (the wrapper's differentiable expand)."""
    from fidelityfusion_tpu_torch.ops.gram import gram, gram_plain

    g = torch.Generator().manual_seed(4)
    x = torch.rand((1024, 4), generator=g).to(dev)
    inv_ls = (torch.rand((4, 1), generator=g) + 0.5).to(dev).requires_grad_(True)
    sv = torch.tensor([0.5, 1.0, 1.5, 2.0], device=dev)
    da = torch.full((4,), 1e-6, device=dev)
    yv = (0.01 * torch.rand((4, 1024), generator=g)).to(dev)
    got = gram(x, x, inv_ls, sv, diag_add=da, y_var=yv)
    torch.cuda.synchronize()
    want = gram_plain(x, x, inv_ls.detach().expand(4, 4), sv, da, yv)
    torch.testing.assert_close(got.detach(), want, rtol=1e-4, atol=1e-5)
    assert (got.diagonal(dim1=1, dim2=2) == sv[:, None] + da[:, None] + yv).all()
    w = torch.randn((1024, 1024), generator=g).to(dev)
    (got * w).sum().backward()
    rep = inv_ls.detach().expand(4, 4).clone().requires_grad_(True)
    (gram_plain(x, x, rep, sv, da, yv) * w).sum().backward()
    torch.testing.assert_close(inv_ls.grad[:, 0], rep.grad.sum(1), rtol=1e-3, atol=1e-3)


def test_kron_nlml_isolates_a_nan_restart_on_the_card(dev):
    """A NaN in one restart's K_0: cuSOLVER's eigh never sees it (the port
    swaps it for the identity), the loss is NaN for that restart only and
    no exception is raised; the other restarts' values and gradients as on
    the CPU."""
    from fidelityfusion_tpu_torch.ops.kron import kron_nlml

    g = torch.Generator().manual_seed(5)

    def spd(R, n):
        a = torch.randn((R, n, n), generator=g, dtype=torch.float64)
        return (a @ a.transpose(1, 2) / n + torch.eye(n, dtype=torch.float64)).float()

    Ks = [spd(4, 256), spd(4, 16), spd(4, 16)]
    Ks[0][2, 3, 5] = float("nan")
    y = torch.randn((256, 16, 16), generator=g)
    noise = torch.full((4,), 0.1)
    cpu = [K.clone().requires_grad_(True) for K in Ks]
    v_cpu = kron_nlml(cpu, y, noise)
    v_cpu[[0, 1, 3]].sum().backward()
    card = [K.to(dev).requires_grad_(True) for K in Ks]
    v = kron_nlml(card, y.to(dev), noise.to(dev))
    v[[0, 1, 3]].sum().backward()
    torch.cuda.synchronize()
    assert torch.isnan(v[2]) and torch.isfinite(v[[0, 1, 3]]).all()
    torch.testing.assert_close(v.cpu()[[0, 1, 3]], v_cpu.detach()[[0, 1, 3]], rtol=1e-4, atol=0)
    for a, b in zip(card, cpu):
        torch.testing.assert_close(a.grad.cpu()[[0, 1, 3]], b.grad[[0, 1, 3]], rtol=1e-3,
                                   atol=1e-5)


@pytest.mark.parametrize("d", [1, 3, 40])
def test_gram_kernel_diagonal_is_exact(dev, d):
    """x1 is x2: the diagonal is sv + diag_add exactly, in every tile."""
    from fidelityfusion_tpu_torch.ops.gram import gram

    g = torch.Generator().manual_seed(1)
    x = torch.randn((300, d), generator=g).to(dev)
    inv_ls = (torch.rand((2, d), generator=g) + 0.5).to(dev)
    sv, da = torch.tensor([0.7, 1.3], device=dev), torch.tensor([1e-2, 3e-4], device=dev)
    got = gram(x, x, inv_ls, sv, diag_add=da)
    torch.cuda.synchronize()
    assert (got.diagonal(dim1=1, dim2=2) == (sv + da)[:, None]).all()


@pytest.mark.parametrize("R,n", [(1, 64), (1, 512), (4, 256), (3, 192), (1, 2048), (4, 1024),
                                 (32, 256)])
def test_chol_and_tri_inv_kernels_match_plain(dev, R, n):
    from fidelityfusion_tpu_torch.ops.chol import chol_inv, chol_inv_plain, tri_inv, tri_inv_plain

    A = _spd(dev, R, n)
    L, Wd = chol_inv(A[0] if R == 1 else A)
    L = L.reshape(R, n, n)
    Lp, Wdp = chol_inv_plain(A)
    rel = ((L - Lp).norm(dim=(1, 2)) / Lp.norm(dim=(1, 2))).max().item()
    assert rel <= 1e-4
    W = tri_inv(L, Wd.reshape(Wdp.shape))
    torch.cuda.synchronize()
    assert (W @ L - torch.eye(n, device=dev)).abs().max().item() <= 1e-3
    torch.testing.assert_close(W, tri_inv_plain(L, Wd.reshape(Wdp.shape)), rtol=1e-3, atol=1e-3)


def test_chol_leaf_kernel_matches_plain(dev):
    from fidelityfusion_tpu_torch.ops.chol import _leaf_chol_inv_rec, chol_leaf

    A = _spd(dev, 8, 64)
    L, W = chol_leaf(A, reps=3)
    Lp, Wp = _leaf_chol_inv_rec(A)
    torch.cuda.synchronize()
    # float32 rounding alone moves single entries of L by ~1e-5 on these
    # blocks, so the bars are the factorization's: relative Frobenius error
    # and the inverse's residual
    for got, want in ((L, Lp), (W, Wp)):
        assert ((got - want).norm(dim=(1, 2)) / want.norm(dim=(1, 2))).max().item() <= 1e-4
    assert (W @ L - torch.eye(64, device=dev)).abs().max().item() <= 1e-3


def test_chol_kernel_negative_pivot_gives_nan_and_returns(dev):
    """A negative pivot in panel 2 of matrix 1: NaN from there on in that
    factor, the other matrices untouched, and the launch completes."""
    from fidelityfusion_tpu_torch.ops.chol import chol_inv, chol_inv_plain

    A = _spd(dev, 3, 512)
    A[1, 150, 150] = -1.0
    L, Wd = chol_inv(A)
    torch.cuda.synchronize()
    assert torch.isnan(L[1, 150:, 150]).all() and torch.isnan(Wd[1, 2:]).any()
    assert torch.isfinite(L[1, :128]).all()
    Lp, _ = chol_inv_plain(A[[0, 2]])
    rel = ((L[[0, 2]] - Lp).norm(dim=(1, 2)) / Lp.norm(dim=(1, 2))).max().item()
    assert rel <= 1e-4


def test_chol_kernel_back_to_back_calls_are_bit_identical(dev):
    from fidelityfusion_tpu_torch.ops.chol import chol_inv

    A = _spd(dev, 4, 512)
    L0, Wd0 = chol_inv(A)
    outs = [chol_inv(A) for _ in range(50)]
    torch.cuda.synchronize()
    assert all(torch.equal(L, L0) and torch.equal(Wd, Wd0) for L, Wd in outs)


def _factor(dev, R, n):
    from fidelityfusion_tpu_torch.ops.chol import chol_inv

    return chol_inv(_spd(dev, R, n))


@pytest.mark.parametrize("R,n", [(2, 64), (1, 128), (3, 192), (2, 320), (3, 384), (1, 1344)])
def test_tri_inv_kernel_odd_block_counts(dev, R, n):
    """nb = 1, 2, 3, 5, 6 and 21 blocks: halves of unequal size at some level."""
    from fidelityfusion_tpu_torch.ops.chol import tri_inv, tri_inv_plain

    L, Wd = _factor(dev, R, n)
    W = tri_inv(L, Wd)
    torch.cuda.synchronize()
    assert (W @ L - torch.eye(n, device=dev)).abs().max().item() <= 1e-3
    torch.testing.assert_close(W, tri_inv_plain(L, Wd), rtol=1e-3, atol=1e-3)
    assert (torch.triu(W, 1) == 0).all()


def test_tri_inv_kernel_isolates_nan(dev):
    """A NaN in matrix 1's L and one in matrix 2's Wd stay in their own W."""
    from fidelityfusion_tpu_torch.ops.chol import tri_inv, tri_inv_plain

    L, Wd = _factor(dev, 4, 384)
    L[1, 200, 70] = float("nan")
    Wd[2, 1, 5, 3] = float("nan")
    W = tri_inv(L, Wd)
    torch.cuda.synchronize()
    assert torch.isnan(W[1]).any() and torch.isnan(W[2]).any()
    assert torch.isfinite(W[[0, 3]]).all()
    torch.testing.assert_close(W[[0, 3]], tri_inv_plain(L[[0, 3]], Wd[[0, 3]]), rtol=1e-3,
                               atol=1e-3)


def test_tri_inv_kernel_back_to_back_calls_are_bit_identical(dev):
    from fidelityfusion_tpu_torch.ops.chol import tri_inv

    L, Wd = _factor(dev, 4, 1024)
    W0 = tri_inv(L, Wd)
    outs = [tri_inv(L, Wd) for _ in range(50)]
    torch.cuda.synchronize()
    assert all(torch.equal(W, W0) for W in outs)


def _toy_manager():
    from fidelityfusion_tpu_torch.demo import _toy_3fid
    from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager

    xs, ys, x_test, _ = _toy_3fid(seed=1)
    return MultiFidelityDataManager([
        {"raw_fidelity_name": str(i), "fidelity_indicator": i, "X": x, "Y": y}
        for i, (x, y) in enumerate(zip(xs, ys))]), x_test


def test_joint_ar_on_the_card_matches_cpu(dev):
    """`train_joint` of a 3-fidelity AR (SE, 30 steps at lr 5e-2) on the
    toy sin, on the card (K1, K2 + K3b a stage) and with ``device="cpu"``
    (the plain versions): every step's loss within 1e-3 of max(|loss|,
    rows), the forward means within 1e-3 of their scale."""
    from fidelityfusion_tpu_torch.models.ar import AR
    from fidelityfusion_tpu_torch.models.joint import train_joint
    from fidelityfusion_tpu_torch.ops import cuda
    from fidelityfusion_tpu_torch.ops.kernels import SquaredExponentialKernel

    out = {}
    for device in ("cpu", dev):
        dm, x_test = _toy_manager()
        model = AR(3, [SquaredExponentialKernel() for _ in range(3)], device=device)
        cuda.reset_launch_counts()
        losses = train_joint(model, dm, max_iter=30, lr_init=5e-2)
        mean, _ = model.forward(dm, x_test)
        out[str(device)] = (losses.cpu(), mean.detach().cpu(), cuda.launch_counts())
    (lc, mc, _), (lg, mg, counts) = out["cpu"], out["cuda"]
    assert all(counts[k] >= 30 for k in ("gram", "chol", "tri_inv")), counts
    rows = sum(len(e["X"]) for e in dm.data_dict.values() if e["fidelity_index"] is not None)
    torch.testing.assert_close(lg, lc, rtol=0, atol=1e-3 * max(lc.abs().max().item(), rows))
    torch.testing.assert_close(mg, mc, rtol=0, atol=1e-3 * mc.abs().max().item())


def test_legacy_cigp_on_the_card_matches_cpu(dev):
    """`LegacyCIGP.fit` (100 steps, 300 rows of the toy's fidelity 0, through
    K1, K2 and K3b on the card) and `forward` on the card and on the CPU:
    losses within 1e-3 of max(|loss|, rows), means within 1e-3 of their
    scale, variances within 1e-3 of the prior's."""
    from fidelityfusion_tpu_torch.demo import _toy_3fid
    from fidelityfusion_tpu_torch.models.legacy import LegacyCIGP
    from fidelityfusion_tpu_torch.ops import cuda

    xs, ys, x_test, _ = _toy_3fid(seed=1)
    out = {}
    for device in ("cpu", dev):
        gp = LegacyCIGP({"input_dim": 1}, device=device)
        cuda.reset_launch_counts()
        losses = gp.fit(xs[0], ys[0], max_iter=100)
        mean, var = gp.forward(x_test)
        sv = gp.core.kernel.signal_variance(gp.params["kernel"]).item()
        out[str(device)] = (losses.cpu(), mean.cpu(), var.cpu(), sv, cuda.launch_counts())
    (lc, mc, vc, sv, _), (lg, mg, vg, _, counts) = out["cpu"], out["cuda"]
    assert all(counts[k] >= 100 for k in ("gram", "chol", "tri_inv")), counts
    torch.testing.assert_close(lg, lc, rtol=0, atol=1e-3 * max(lc.abs().max().item(), 300))
    torch.testing.assert_close(mg, mc, rtol=0, atol=1e-3 * mc.abs().max().item())
    torch.testing.assert_close(vg, vc, rtol=0, atol=1e-3 * sv)


def test_bo_ucb_iteration_on_the_card_matches_cpu(dev):
    """One UCB iteration of `mf_bo_discrete` (iteration 0, seed 0, the
    AR surrogate on Forrester's {1: 10, 2: 4} design) on the card and on
    the CPU, from the same starts: the same fidelity, and the CPU's
    acquisition at the card's x within 1e-3 (relative) of the CPU's best;
    K1, K2, K3a and K3b launched on the card."""
    import math

    import numpy as np

    from fidelityfusion_tpu_torch.bo.loop import acquire, fit_surrogate, generator
    from fidelityfusion_tpu_torch.data.objectives import Forrester
    from fidelityfusion_tpu_torch.ops import cuda

    f = Forrester(2)
    xs, ys = f.initiate_data({1: 10, 2: 4}, 0)
    beta = 0.2 * math.log(1.1)
    f_best = float(max(np.max(y) for y in ys))
    out = []
    for device in (torch.device("cpu"), dev):
        cuda.reset_launch_counts()
        model, dm = fit_surrogate(f, list(xs), list(ys), device=device)
        out += [acquire(model, dm, "UCB", beta, f_best, [[0.0, 1.0]], [0.01, 0.01],
                                   generators=[generator(0, 0, s) for s in range(2)])]
        counts = cuda.launch_counts()
    (x_cpu, s_cpu, v_cpu, scores), (x_card, s_card, _, _) = out
    assert s_card == s_cpu
    with torch.no_grad():  # the acquisition of x: its best score over the fidelities
        v = max(float(score(torch.as_tensor(x_card), state, torch.tensor(f_best)))
                for score, state in scores)
    assert abs(v - v_cpu) <= 1e-3 * abs(v_cpu), (v, v_cpu)
    assert all(counts.get(k, 0) > 0 for k in ("gram", "chol", "chol_batched", "tri_inv")), counts


def test_ar_posterior_x_gradient_on_the_card_matches_cpu(dev):
    """`ARPosterior` over one AR's parameters and stage datasets, exported
    on the card and on the CPU: mean, variance and the x-gradient of their
    sum at 64 points within 1e-4 of their scale (the variance's: the
    prior's, at a far point); the card's backward
    launches K1 (a forward and a backward a stage) and never `gram_plain`."""
    import numpy as np

    from fidelityfusion_tpu_torch.bo.loop import fit_surrogate
    from fidelityfusion_tpu_torch.convert import load_state
    from fidelityfusion_tpu_torch.data.objectives import Forrester
    from fidelityfusion_tpu_torch.models.ar import AR
    from fidelityfusion_tpu_torch.ops import cuda, gram
    from fidelityfusion_tpu_torch.ops.kernels import SquaredExponentialKernel
    from fidelityfusion_tpu_torch.utils.tree import tree_map

    f = Forrester(2)
    xs, ys = f.initiate_data({1: 10, 2: 4}, 1)
    cpu_model, dm = fit_surrogate(f, list(xs), list(ys), train_iters=30, device="cpu")
    card_model = AR(2, [SquaredExponentialKernel() for _ in range(2)], if_nonsubset=True,
                    device=dev)
    load_state(card_model, tree_map(lambda a: a.numpy(), cpu_model.params),
               cpu_model.stage_norm)
    x = np.linspace(0.0, 1.0, 64, dtype=np.float32).reshape(-1, 1)
    out = []
    plain_calls = []
    real_plain = gram.gram_plain
    for model in (cpu_model, card_model):
        post, state = model.export_posterior(dm, pad_multiple=16)
        xt = torch.as_tensor(x, device=model.device).requires_grad_()
        if model is card_model:
            gram.gram_plain = lambda *a, **k: plain_calls.append(1) or real_plain(*a, **k)
            cuda.reset_launch_counts()
        try:
            mean, var = post(state, xt)
            (g,) = torch.autograd.grad(mean.sum() + var.sum(), xt)
            if model is card_model:
                torch.cuda.synchronize()
                k1 = cuda.launch_counts().get("gram", 0)
        finally:
            gram.gram_plain = real_plain
        out.append([a.detach().cpu() for a in (mean, var, g)])
    with torch.no_grad():
        post_c, state_c = cpu_model.export_posterior(dm)
        prior = post_c(state_c, torch.tensor([[1e3]]))[1].item()
    (mc, vc, gc), (md, vd, gd) = out
    torch.testing.assert_close(md, mc, rtol=0, atol=1e-4 * mc.abs().max().item())
    torch.testing.assert_close(vd, vc, rtol=0, atol=1e-4 * prior)
    torch.testing.assert_close(gd, gc, rtol=0, atol=1e-4 * gc.abs().max().item())
    assert k1 == 4 and not plain_calls, (k1, len(plain_calls))


def test_run_single_on_the_card_matches_cpu(dev):
    """One AR grid cell of the sweep harness (forrester12, n_high 16, the
    harness's defaults: 100 low rows, 100 test points, 200 steps, 4
    restarts, lr 5e-2) on the card and on the CPU: RMSE within 5%
    relative, r2 within 1e-2; K1, K3a and K3b launched on the card."""
    from fidelityfusion_tpu_torch.experiments.sweep import run_single
    from fidelityfusion_tpu_torch.ops import cuda

    cpu = run_single("AR", "forrester12", 0, 16, device="cpu")
    cuda.reset_launch_counts()
    card = run_single("AR", "forrester12", 0, 16, device=dev)
    counts = cuda.launch_counts()
    assert abs(card["rmse"] - cpu["rmse"]) <= 0.05 * cpu["rmse"], (card, cpu)
    assert abs(card["r2"] - cpu["r2"]) <= 1e-2, (card, cpu)
    assert all(counts.get(k, 0) > 0 for k in ("gram", "chol_batched", "tri_inv")), counts


def test_mlp_objective_on_the_card_matches_cpu(dev):
    """`MLPTrainingObjective.get_data` at two hyperparameter rows and s = 1,
    2 on the card and on the CPU (the same seeded data and weights): the
    validation accuracies within 1/n_val, the final validation logits
    within 1e-3 of their max |.|."""
    import numpy as np

    from fidelityfusion_tpu_torch.data.real_app import MLPTrainingObjective

    cpu, card = MLPTrainingObjective(2, device="cpu"), MLPTrainingObjective(2, device=dev)
    x = np.array([[-2.0, 0.5], [-1.3, 0.9]])
    n_val = len(cpu.y_val)
    for s in (1, 2):
        np.testing.assert_allclose(card.get_data(x, s), cpu.get_data(x, s), rtol=0,
                                   atol=1.0 / n_val)
        for row in x:
            lc = cpu._val_logits(row[0], row[1], 10 * s)
            lg = card._val_logits(row[0], row[1], 10 * s).cpu()
            torch.testing.assert_close(lg, lc, rtol=0, atol=1e-3 * lc.abs().max().item())


def test_cigp_nll_nsharded_world_of_one_on_the_card_matches_cpu(dev):
    """`cigp_nll_nsharded` over a world of one rank on the card (NCCL,
    started by `make_n_mesh`) against the unsharded NLML of the same data on
    the CPU: value within 1e-4 of max(1, |v|), every gradient leaf within
    1e-3 of its max; K1, K2 and K3b launched, the plain versions not."""
    import numpy as np
    import torch.distributed as dist

    from fidelityfusion_tpu_torch.models.cigp import CIGP
    from fidelityfusion_tpu_torch.ops import cuda
    from fidelityfusion_tpu_torch.ops.kernels import ARDKernel
    from fidelityfusion_tpu_torch.parallel import cigp_nll_nsharded, make_n_mesh
    from fidelityfusion_tpu_torch.utils.tree import tree_leaves, tree_map

    rng = np.random.default_rng(0)
    x = (rng.random((512, 2)) * 4).astype(np.float32)
    y = (np.sin(x.sum(1, keepdims=True)) + 0.1 * rng.standard_normal((512, 1))).astype(np.float32)
    gp = CIGP(kernel=ARDKernel(), se_analytic_nll=False, hybrid_nll=False)

    def value_grad(fn, device):
        p = tree_map(lambda a: a.requires_grad_(True), gp.init_params(2, device=device))
        v = fn(p, torch.tensor(x, device=device), torch.tensor(y, device=device))
        return float(v), [g.cpu() for g in torch.autograd.grad(v, tree_leaves(p))]

    try:
        mesh = make_n_mesh()
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        cuda.reset_launch_counts()
        v, g = value_grad(lambda p, xx, yy: cigp_nll_nsharded(gp, p, xx, yy, mesh), dev)
        counts = cuda.launch_counts()
    finally:
        dist.destroy_process_group()
    v_cpu, g_cpu = value_grad(lambda p, xx, yy: gp.nll(p, xx, yy), "cpu")
    assert abs(v - v_cpu) <= 1e-4 * max(1.0, abs(v_cpu)), (v, v_cpu)
    for a, b in zip(g, g_cpu):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3 * b.abs().max().item())
    assert all(counts.get(k, 0) > 0 for k in ("gram", "chol", "tri_inv")), counts
