"""Blocked Cholesky + triangular inverse: the (L, W = inv(L)) contract.

Port of `fidelityfusion_tpu/ops/blocked.py`.  The JAX module shapes its
factorization so that `vmap` turns every O(n^3) term into a batched GEMM;
here the same factorization is a hand-written kernel pair with an explicit
batch dimension (`ops/chol.py`: K2/K3a factor with fused leaf inverses,
K3b assembles inv(L) by `_tri_inv_assemble`'s recursion), and everything
in this module composes it:

  * `blocked_chol_inv_v2` / `blocked_chol_inv` - (L, W) of a block-multiple
    SPD matrix (or batch);
  * `chol_inv_padded` - the same for any n, identity-padded and cropped;
  * `tri_inv_gemm` - W for a lower-triangular L given alone;
  * `mvn_nll_blocked`, `mvn_nll_hybrid` - the NLML with its closed-form
    VJP (`ops/linalg.py:_MvnNll`): the restart-batch path and the
    single-matrix large-n path, which in the port differ only in padding.

The JAX package's ``precision`` knobs (TPU matmul passes) and its choice of
XLA primitive for the diagonal blocks have no counterpart: every product
here is full fp32, and the diagonal blocks are always the kernel's fused
rank-1 leaf.
"""

from __future__ import annotations

from typing import Tuple

import torch

from fidelityfusion_tpu_torch.ops.chol import (
    PANEL, _leaf_chol_inv, _tri_inv_assemble, chol_inv, tri_inv)
from fidelityfusion_tpu_torch.ops.linalg import LOG2PI, mvn_nll_fused

__all__ = [
    "_leaf_chol_inv", "_tri_inv_assemble", "blocked_chol_inv",
    "blocked_chol_inv_v2", "chol_inv_padded", "tri_inv_gemm",
    "mvn_nll_hybrid", "mvn_nll_blocked", "auto_block", "hybrid_block",
]


def _check_block(n: int, block: int) -> None:
    if block % PANEL:
        raise ValueError(f"block={block} must be a multiple of the kernel panel {PANEL}")
    if n % block:
        raise ValueError(f"n={n} not a multiple of block={block}")


def blocked_chol_inv_v2(A: torch.Tensor, block: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lower Cholesky factor L of SPD ``A (*batch, n, n)`` and W = inv(L),
    n a multiple of ``block``: K2/K3a then K3b on the card."""
    _check_block(A.shape[-1], block)
    L, Wd = chol_inv(A)
    return L, tri_inv(L, Wd)


def blocked_chol_inv(A: torch.Tensor, block: int = 64,
                     leaf: str = "fused") -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, W) as `blocked_chol_inv_v2`.  The JAX leaf names differ there
    in which XLA primitive factors the diagonal blocks ("fused", "xla",
    "v2", "v2f") or in assembling W by `_tri_inv_assemble` ("hybrid"),
    which is K3b's recursion; all map to the one kernel pair here."""
    if leaf not in ("fused", "xla", "hybrid", "v2", "v2f"):
        raise ValueError(f"unknown leaf {leaf!r}")
    return blocked_chol_inv_v2(A, block=block)


def _pad_identity(A: torch.Tensor, n_pad: int) -> torch.Tensor:
    """[[A, 0], [0, I]] of size n_pad (leading batch kept)."""
    n = A.shape[-1]
    if n_pad == n:
        return A
    out = A.new_zeros(A.shape[:-2] + (n_pad, n_pad))
    out[..., :n, :n] = A
    out.diagonal(dim1=-2, dim2=-1)[..., n:] = 1.0
    return out


def chol_inv_padded(Sigma: torch.Tensor, block: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, W = inv(L)) for SPD ``Sigma`` of any n: identity-padded to a
    block multiple (``block=0`` is the kernel panel), factored, cropped.
    inv([[L, 0], [0, I]]) = [[inv(L), 0], [0, I]], so cropping is exact."""
    n = Sigma.shape[-1]
    block = block or PANEL
    n_pad = -(-n // block) * block
    L, W = blocked_chol_inv_v2(_pad_identity(Sigma, n_pad), block=block)
    return L[..., :n, :n], W[..., :n, :n]


def _tri_inv_lower(Ld: torch.Tensor) -> torch.Tensor:
    """Inverse of (B, b, b) lower-triangular blocks by forward substitution,
    one row at a time (benchmarks/retired/pallas_cholesky.py:_tri_inv_lower)."""
    b = Ld.shape[-1]
    X = torch.zeros_like(Ld)
    eye = torch.eye(b, dtype=Ld.dtype, device=Ld.device)
    for c in range(b):
        acc = (Ld[:, c, None, :c] @ X[:, :c, :])[:, 0]
        X[:, c, :] = (eye[c] - acc) / Ld[:, c, c, None]
    return X


def tri_inv_gemm(L: torch.Tensor, block: int = 0) -> torch.Tensor:
    """W = inv(L) for a lower-triangular ``L`` given without its factorization
    (any n; identity-padded to ``block``, by default `hybrid_block`, and
    cropped): the diagonal blocks are inverted
    by forward substitution, then K3b assembles W.  Off the main path, which
    always has the leaf's inverses from `chol_inv`."""
    n = L.shape[-1]
    block = block or hybrid_block(n)
    Lp = _pad_identity(L, -(-n // block) * block)
    _check_block(Lp.shape[-1], block)
    nb = Lp.shape[-1] // PANEL
    L3 = Lp.reshape((-1,) + Lp.shape[-2:])
    blocks = torch.stack([L3[:, k * PANEL:(k + 1) * PANEL, k * PANEL:(k + 1) * PANEL]
                          for k in range(nb)], 1)
    Wd = _tri_inv_lower(blocks.reshape(-1, PANEL, PANEL)).reshape(blocks.shape)
    W = tri_inv(L3.contiguous(), Wd.contiguous()).reshape(Lp.shape)
    return W[..., :n, :n]


def hybrid_block(n: int) -> int:
    """Padding block of `tri_inv_gemm` (the JAX package's policy)."""
    return 256 if n <= 2048 else 1024


def auto_block(n: int) -> int:
    """Padding block of the restart-batch path: 128 from 320 rows, else 64."""
    return 128 if n >= 320 else 64


def mvn_nll_hybrid(Sigma: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """NLML of y ~ N(0, Sigma) for one large matrix, GEMM-only solves and
    VJP around the factorization (same value/gradient contract as
    `linalg.mvn_nll_fused`).  ``y`` must be (n, d).  The JAX version's
    ``block`` tuned its inverse assembly; the kernels pad to their panel."""
    return mvn_nll_fused(Sigma, y)


def mvn_nll_blocked(Sigma: torch.Tensor, y: torch.Tensor, block: int = 0,
                    mask=None) -> torch.Tensor:
    """NLML for restart batches (``Sigma (*batch, n, n)``), GEMM-only.

    Pads Sigma with identity rows and y with zero rows to a multiple of
    ``block`` (``0`` selects `auto_block`) and removes the padded rows'
    2 pi terms, so the value and gradients equal the unpadded ones.  With
    ``mask``, Sigma must already hold identity rows at masked entries;
    their targets are zeroed here and only live rows count in the 2 pi
    constant - exactly `linalg.mvn_nll`'s masked value.
    """
    if y.ndim == 1:
        y = y[:, None]
    n = Sigma.shape[-1]
    d = y.shape[-1]
    block = block or auto_block(n)
    mask_correction = 0.0
    if mask is not None:
        y = y * mask[:, None].to(y.dtype)
        mask_correction = 0.5 * (n - mask.sum().to(y.dtype)) * d * LOG2PI
    n_pad = -(-n // block) * block
    extra = n_pad - n
    if extra:
        Sigma = _pad_identity(Sigma, n_pad)
        y = torch.cat([y, y.new_zeros(y.shape[:-2] + (extra, d))], dim=-2)
    return mvn_nll_fused(Sigma, y) - 0.5 * extra * d * LOG2PI - mask_correction
