"""K5, the small-Gram eigendecomposition (`ops/kron.py:small_eigh`,
`csrc/small_eigh.cu`): `eigh_pairs`' routing and counters on the CPU, and
the kernel on the card.

A CPU tensor never reaches K5, so the routing tests stand a tensor that
reports itself as CUDA (`_OnCard`) in for a card tensor, with the kernel's
wrapper replaced by a recorder.  The tests marked ``cuda`` skip where there
is no CUDA device (decided inside the fixture, never at import).  Run them
on a card:

    python -m pytest tests/test_torch_small_eigh.py -q -m cuda --noconftest

Bounds on the card, against ``torch.linalg.eigh`` in float64 on the same
matrices, with eps = 2^-53: |dlambda| <= 10 n eps ||K||_2, ||K V - V
diag(w)||_F <= 10 n eps ||K||_F, max |V^T V - I| <= 10 n eps: a backward-
stable eigensolver's bounds with a factor of 10 for the sums' order.
"""

import numpy as np
import pytest
import torch

from fidelityfusion_tpu_torch.ops import kron, spectral

EPS = 2.0 ** -53
SMALL_EIGH = kron.small_eigh  # the wrapper, before any test replaces it


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as CUDA, for the routing tests."""

    @property
    def is_cuda(self):
        return True


def _se(n, ls, sv=1.0, dtype=torch.float64):
    g = torch.arange(n, dtype=dtype)
    return sv * torch.exp(-0.5 * (g[:, None] - g[None, :]) ** 2 / ls ** 2)


@pytest.fixture
def k5_recorder(monkeypatch):
    """`kron.small_eigh` replaced by `eigh_plain`, recording each call's n."""
    calls = []

    def fake(K):
        calls.append(K.shape[-1])
        return kron.eigh_plain(K.as_subclass(torch.Tensor))

    monkeypatch.setattr(kron, "small_eigh", fake)
    spectral.reset_spectral_counts()
    yield calls
    spectral.reset_spectral_counts()


@pytest.mark.parametrize("case", ["cpu", "above_cap", "records_grad"])
def test_eigh_pairs_keeps_the_library_where_k5_does_not_apply(k5_recorder, case):
    n = kron.SMALL_EIGH_MAX_N + 1 if case == "above_cap" else 8
    K = torch.stack([_se(n, 1.5), _se(n, 3.0, 2.0)])
    if case != "cpu":
        K = K.as_subclass(_OnCard)
    if case == "records_grad":
        K.requires_grad_(True)
    launches = kron.SMALL_EIGH_LAUNCHES.launches
    with torch.enable_grad():
        w, V = kron.eigh_pairs(K)
    assert k5_recorder == [] and kron.SMALL_EIGH_LAUNCHES.launches == launches
    counts = spectral.spectral_counts()
    assert counts["small_eigh"] == {} and counts["library_eigh"] == {n: 1}
    w0, V0 = kron.eigh_plain(K.detach().as_subclass(torch.Tensor))
    assert torch.equal(w.detach().as_subclass(torch.Tensor), w0)
    assert torch.equal(V.detach().as_subclass(torch.Tensor), V0)


@pytest.mark.parametrize("grad", ["no_grad", "grad_not_needed"])
def test_eigh_pairs_routes_small_card_grams_to_k5(k5_recorder, grad):
    """On the card, at most `SMALL_EIGH_MAX_N` rows and no autograd record
    through K (inside `_KronNLML.forward`, under ``no_grad``, or K not
    requiring grad): K5, in K's dtype."""
    K = torch.stack([_se(8, 2.0), _se(8, 0.5)]).float().as_subclass(_OnCard)
    ctx = torch.no_grad() if grad == "no_grad" else torch.enable_grad()
    with ctx:
        w, V = kron.eigh_pairs(K)
    assert k5_recorder == [8]
    assert w.dtype == V.dtype == torch.float32
    assert spectral.spectral_counts()["small_eigh"] == {8: 1}


def test_spectral_counts_count_eigh_routes_by_n_and_reset(k5_recorder):
    for n in (3, 5, 5):
        kron.eigh_pairs(_se(n, 1.0))
    for n in (8, 8, 16):
        kron.eigh_pairs(_se(n, 1.0).as_subclass(_OnCard))
    counts = spectral.spectral_counts()
    assert counts["library_eigh"] == {3: 1, 5: 2}
    assert counts["small_eigh"] == {8: 2, 16: 1}
    assert counts["refresh"] == {} and counts["jacobi"] == {}
    spectral.reset_spectral_counts()
    assert spectral.spectral_counts() == {"refresh": {}, "jacobi": {}, "small_eigh": {},
                                          "library_eigh": {}}


def test_eigh_pairs_takes_k5_up_to_its_limit(k5_recorder):
    """K5 takes a Gram of exactly `SMALL_EIGH_MAX_N` rows, and its wrapper
    refuses a CPU tensor instead of handing it to the kernel."""
    n = kron.SMALL_EIGH_MAX_N
    kron.eigh_pairs(_se(n, 2.0).as_subclass(_OnCard))
    assert k5_recorder == [n]
    assert spectral.spectral_counts()["small_eigh"] == {n: 1}
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        SMALL_EIGH(_se(8, 1.0))


# ---- on the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _se_batch(B, n, seed):
    """B SE Grams on the integer grid 0..n-1 at length scales spread over
    0.5 to 4 grid steps (4 alone at B = 1, the most nearly singular) and
    signal variances in [0.5, 2]: eigenvalues down to ~1e-16 of the largest."""
    ls = torch.tensor([4.0]) if B == 1 else torch.linspace(0.5, 4.0, B)
    sv = 0.5 + 1.5 * torch.rand(B, generator=torch.Generator().manual_seed(seed),
                                dtype=torch.float64)
    return torch.stack([_se(n, float(a), float(s)) for a, s in zip(ls, sv)])


def _repeated_batch(B, n, seed):
    """Matrices with repeated eigenvalues: the identity, blocks of equal
    rows (eigenvalues 0 and the block size, each repeated), and a rotated
    diagonal holding each of two values n / 2 times."""
    gen = torch.Generator().manual_seed(seed)
    block = max(1, n // 4)
    ones = torch.block_diag(*[torch.ones(block, block, dtype=torch.float64)] * (n // block))
    blocks = torch.zeros(n, n, dtype=torch.float64)
    blocks[:ones.shape[0], :ones.shape[0]] = ones
    Q, _ = torch.linalg.qr(torch.randn(n, n, generator=gen, dtype=torch.float64))
    d = torch.where(torch.arange(n) < n // 2, 1.0, 3.0).double()
    rotated = Q @ torch.diag(d) @ Q.T
    kinds = [torch.eye(n, dtype=torch.float64), blocks, rotated]
    return torch.stack([kinds[b % 3] for b in range(B)])


def _check_pairs(K, w, V):
    """The bounds of the module docstring, per matrix, against
    ``torch.linalg.eigh`` on the same (symmetrized) matrices."""
    n = K.shape[-1]
    Ks = 0.5 * (K + K.transpose(-1, -2))
    w_ref = torch.linalg.eigh(Ks)[0]
    norm2 = w_ref.abs().amax(-1)
    fro = torch.linalg.matrix_norm(Ks)
    assert bool((w[:, 1:] >= w[:, :-1]).all()), "values not ascending"
    dl = (w - w_ref).abs().amax(-1)
    assert bool((dl <= 10 * n * EPS * norm2).all()), (dl / (n * EPS * norm2)).tolist()
    res = torch.linalg.matrix_norm(Ks @ V - V * w[:, None, :])
    assert bool((res <= 10 * n * EPS * fro).all()), (res / (n * EPS * fro)).tolist()
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    orth = (V.transpose(-1, -2) @ V - eye).abs().amax((-2, -1))
    assert bool((orth <= 10 * n * EPS).all()), (orth / (n * EPS)).tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["se", "repeated"])
@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 16, 31, 32, 64])
@pytest.mark.parametrize("B", [1, 4, 8])
def test_k5_matches_library_eigh(dev, B, n, kind):
    K = (_se_batch if kind == "se" else _repeated_batch)(B, n, seed=n).to(dev)
    before = kron.SMALL_EIGH_LAUNCHES.launches
    w, V = kron.small_eigh(K)
    torch.cuda.synchronize()
    assert kron.SMALL_EIGH_LAUNCHES.launches == before + 1
    assert w.shape == (B, n) and V.shape == (B, n, n) and w.dtype == torch.float64
    _check_pairs(K, w, V)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 31])
def test_k5_flags_nonfinite_matrices_only(dev, n):
    K = _se_batch(4, n, seed=1).to(dev)
    K[1, 2, 0] = float("nan")
    K[2, n - 1, n - 1] = float("inf")
    w, V = kron.small_eigh(K)
    torch.cuda.synchronize()
    eye = torch.eye(n, dtype=K.dtype, device=dev)
    for b in (1, 2):
        assert bool(torch.isnan(w[b]).all()) and torch.equal(V[b], eye)
    keep = torch.tensor([0, 3], device=dev)
    assert bool(torch.isfinite(w[keep]).all())
    _check_pairs(K[keep], w[keep], V[keep])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16, 32])
def test_kron_nlml_and_gradient_match_the_library_path(dev, d, monkeypatch):
    """`kron_nlml` and its closed-form gradient at a (d, d) field over 4
    restarts, the mode Grams through K5, against the same call with every
    Gram through ``torch.linalg.eigh``, to 1e-10 relative."""
    gen = torch.Generator().manual_seed(d)
    R, n0 = 4, 100
    x = torch.rand((n0, 4), generator=gen, dtype=torch.float64)
    sq = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    ls = torch.linspace(0.7, 2.5, R, dtype=torch.float64)
    K0 = torch.exp(-0.5 * sq[None] / ls[:, None, None] ** 2) + 1e-6 * torch.eye(n0)
    K1 = torch.stack([_se(d, float(a), 1.3) for a in ls])
    K2 = torch.stack([_se(d, float(a) * 1.7, 0.8) for a in ls])
    y = torch.randn((n0, d, d), generator=gen, dtype=torch.float64)
    noise = torch.linspace(5.0, 50.0, R, dtype=torch.float64)

    def run():
        args = [t.to(dev).requires_grad_(True) for t in (K0, K1, K2, y, noise)]
        loss = kron.kron_nlml(args[:3], args[3], args[4])
        loss.sum().backward()
        return [loss.detach()] + [a.grad for a in args]

    launches = kron.SMALL_EIGH_LAUNCHES.launches
    got = run()
    assert kron.SMALL_EIGH_LAUNCHES.launches == launches + 2
    monkeypatch.setattr(kron, "small_eigh", kron.eigh_plain)
    want = run()
    assert kron.SMALL_EIGH_LAUNCHES.launches == launches + 2
    for name, a, b in zip(("loss", "K0", "K1", "K2", "y", "noise"), got, want):
        rel = (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()
        assert rel <= 1e-10, (name, rel)
