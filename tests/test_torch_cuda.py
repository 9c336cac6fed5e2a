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


@pytest.mark.parametrize("n1,n2,d", [(256, 256, 1), (100, 37, 3), (64, 200, 40)])
def test_gram_kernel_matches_plain(dev, n1, n2, d):
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


@pytest.mark.parametrize("R,n", [(1, 64), (1, 512), (4, 256), (3, 192)])
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
