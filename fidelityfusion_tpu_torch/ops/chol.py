"""K2 + K3a (`csrc/chol.cu`) and K3b (`csrc/tri_inv.cu`): the blocked
Cholesky with its diagonal-block inverses, and the triangular inverse.

    L, Wd = chol_inv(A)      # A (n, n) -> K2,  A (R, n, n) -> K3a
    W     = tri_inv(L, Wd)   # W = inv(L), K3b

``n`` must be a multiple of `PANEL`; `chol_inv_padded` takes any n, pads
it with identity rows and crops the result.  ``Wd`` holds the inverses of
L's 64x64 diagonal blocks, ``(*batch, n/64, 64, 64)``; the leaf produces
them while it factors, so the inverse needs no triangular solve anywhere.

Each wrapper launches its kernel on CUDA tensors (float32, contiguous) and
runs the plain PyTorch version on CPU tensors; `chol_inv_plain` and
`tri_inv_plain` follow the kernels' blocking step for step.  Neither is
differentiated: the NLML and posterior functions that call them carry
closed-form backward passes (`ops/linalg.py`, `ops/fused_se.py`).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from fidelityfusion_tpu_torch.ops import cuda

PANEL = 64
LEAF_BASE = 32  # the leaf's base case: one warp factors a 32x32 block in registers

_CHOL = cuda.Library("chol.cu", {
    "ff_chol_inv": [cuda.PTR] * 3 + [cuda.INT] * 2 + [cuda.PTR],
    "ff_chol_leaf": [cuda.PTR] * 3 + [cuda.INT] * 2 + [cuda.PTR],
})
_TRI = cuda.Library("tri_inv.cu", {"ff_tri_inv": [cuda.PTR] * 4 + [cuda.INT] * 2 + [cuda.PTR]})
CHOL_LAUNCHES = cuda.counter("chol")              # K2: one matrix
CHOL_BATCHED_LAUNCHES = cuda.counter("chol_batched")  # K3a: a batch
CHOL_LEAF_LAUNCHES = cuda.counter("chol_leaf")    # the K2/K3a leaf alone (checks, timing)
TRI_INV_LAUNCHES = cuda.counter("tri_inv")        # K3b


def _leaf_chol_inv(D: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unblocked Cholesky of (B, b, b) SPD blocks fused with their inverses
    (`fidelityfusion_tpu/ops/blocked.py:_leaf_chol_inv`): per column, a
    rank-1 trailing update of the factor and a rank-1 row update of the
    running inverse.  A negative or NaN pivot propagates as NaN."""
    b = D.shape[-1]
    idx = torch.arange(b, device=D.device)
    a = D.clone()
    w = torch.eye(b, dtype=D.dtype, device=D.device).expand_as(D).clone()
    for j in range(b):
        d = torch.sqrt(a[:, j, j])
        col = a[:, :, j] / d[:, None]
        below = idx > j
        colm = torch.where(below, col, torch.zeros_like(col))
        a[:, :, j] = torch.where(idx == j, d[:, None], torch.where(below, col, a[:, :, j]))
        a = a - colm[:, :, None] * colm[:, None, :]
        wj = w[:, j, :] / d[:, None]
        w[:, j, :] = wj
        w = w - colm[:, :, None] * wj[:, None, :]
    return torch.tril(a), w


def _leaf_chol_inv_rec(D: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's leaf on (B, b, b) SPD blocks: halve as
    `benchmarks/retired/pallas_batched.py:_chol_recursive` does, with
    `_leaf_chol_inv` on `LEAF_BASE`-wide diagonal blocks and the inverse
    built as `_tri_inv_recursive` does:
    L21 = A21 W11^T,  L22 W22 = leaf(A22 - L21 L21^T),  W21 = -W22 (L21 W11)."""
    b = D.shape[-1]
    if b <= LEAF_BASE:
        return _leaf_chol_inv(D)
    h = b // 2
    L11, W11 = _leaf_chol_inv_rec(D[:, :h, :h])
    L21 = D[:, h:, :h] @ W11.transpose(1, 2)
    L22, W22 = _leaf_chol_inv_rec(D[:, h:, h:] - L21 @ L21.transpose(1, 2))
    W21 = -(W22 @ (L21 @ W11))
    z = D.new_zeros(D.shape[:-2] + (h, b - h))
    return (torch.cat([torch.cat([L11, z], -1), torch.cat([L21, L22], -1)], -2),
            torch.cat([torch.cat([W11, z], -1), torch.cat([W21, W22], -1)], -2))


def chol_inv_plain(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2/K3a on (B, n, n): right-looking over 64-column
    panels; the recursive leaf (`_leaf_chol_inv_rec`), panel product with
    the leaf's inverse, Schur update.  (The kernel factors panel k + 1's
    diagonal block while the rest of panel k's update runs: a schedule, the
    same arithmetic.)  Returns (L, Wd) with Wd (B, n/64, 64, 64)."""
    B, n, _ = A.shape
    nb = n // PANEL
    work = A.clone()
    Wd = A.new_empty((B, nb, PANEL, PANEL))
    for k in range(nb):
        s, e = k * PANEL, (k + 1) * PANEL
        Ld, Wk = _leaf_chol_inv_rec(work[:, s:e, s:e])
        work[:, s:e, s:e] = Ld
        Wd[:, k] = Wk
        if e < n:
            L21 = work[:, e:, s:e] @ Wk.transpose(1, 2)
            work[:, e:, s:e] = L21
            work[:, e:, e:] -= L21 @ L21.transpose(1, 2)
    return torch.tril(work), Wd


def _tri_inv_assemble(L: torch.Tensor, diag_invs: List[torch.Tensor],
                      block: int) -> torch.Tensor:
    """inv(L) from its per-block diagonal inverses by divide and conquer
    (`fidelityfusion_tpu/ops/blocked.py:_tri_inv_assemble`, hb = nb // 2):
    inv([[A, 0], [B, C]]) = [[iA, 0], [-iC (B iA), iC]] (plain GEMMs)."""
    nb = len(diag_invs)
    if nb == 1:
        return diag_invs[0].clone()
    hb = nb // 2
    h = hb * block
    W1 = _tri_inv_assemble(L[..., :h, :h], diag_invs[:hb], block)
    W2 = _tri_inv_assemble(L[..., h:, h:], diag_invs[hb:], block)
    W21 = -(W2 @ (L[..., h:, :h] @ W1))
    z = L.new_zeros(L.shape[:-2] + (h, L.shape[-1] - h))
    return torch.cat([torch.cat([W1, z], -1), torch.cat([W21, W2], -1)], -2)


def tri_inv_plain(L: torch.Tensor, Wd: torch.Tensor) -> torch.Tensor:
    """Plain version of K3b on (B, n, n): `_tri_inv_assemble` from the
    64x64 blocks of Wd, each node T = L21 W11, then W21 = -W22 T.  (The
    kernel runs the nodes level by level, deepest first, each phase over
    the whole grid: a schedule, the same arithmetic.)"""
    return _tri_inv_assemble(L, list(Wd.unbind(1)), PANEL)


def _check_square(name, A):
    if A.ndim not in (2, 3) or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"{name}: expected (n, n) or (B, n, n), got {tuple(A.shape)}")
    if A.shape[-1] % PANEL:
        raise ValueError(f"{name}: n={A.shape[-1]} is not a multiple of {PANEL}")


def chol_inv(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, Wd) of SPD ``A``: (n, n) is K2, (B, n, n) is K3a."""
    _check_square("chol_inv", A)
    A3 = A.reshape((-1,) + A.shape[-2:])
    if not A.is_cuda:
        L, Wd = chol_inv_plain(A3)
    else:
        A3 = A3.contiguous()
        cuda.require_cuda("chol_inv", A3)
        B, n, _ = A3.shape
        L = torch.empty_like(A3)  # the kernel writes every element of L
        Wd = torch.empty((B, n // PANEL, PANEL, PANEL), dtype=A3.dtype, device=A3.device)
        if B and n:
            _CHOL.call("ff_chol_inv", A3.data_ptr(), L.data_ptr(), Wd.data_ptr(), B, n,
                       cuda.stream_ptr(A3.device))
            (CHOL_LAUNCHES if A.ndim == 2 else CHOL_BATCHED_LAUNCHES).launches += 1
    return L.reshape(A.shape), Wd.reshape(A.shape[:-2] + Wd.shape[1:])


def chol_leaf(D: torch.Tensor, reps: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, W = inv(L)) of (B, 64, 64) SPD blocks by K2/K3a's leaf alone, one
    CTA per block (`_leaf_chol_inv_rec` on CPU tensors).  ``reps`` > 1
    repeats each factorization inside the launch, to time the leaf without
    the launch."""
    if D.ndim != 3 or D.shape[-2:] != (PANEL, PANEL):
        raise ValueError(f"chol_leaf: expected (B, {PANEL}, {PANEL}), got {tuple(D.shape)}")
    if not D.is_cuda:
        return _leaf_chol_inv_rec(D)
    D = D.contiguous()
    cuda.require_cuda("chol_leaf", D)
    L, W = torch.empty_like(D), torch.empty_like(D)
    if D.shape[0]:
        _CHOL.call("ff_chol_leaf", D.data_ptr(), L.data_ptr(), W.data_ptr(), D.shape[0],
                   max(1, reps), cuda.stream_ptr(D.device))
        CHOL_LEAF_LAUNCHES.launches += 1
    return L, W


def tri_inv(L: torch.Tensor, Wd: torch.Tensor) -> torch.Tensor:
    """W = inv(L) from L and its diagonal-block inverses (K3b: one
    cooperative launch)."""
    _check_square("tri_inv", L)
    n = L.shape[-1]
    L3 = L.reshape((-1, n, n))
    Wd4 = Wd.reshape((-1, n // PANEL, PANEL, PANEL))
    if Wd4.shape[0] != L3.shape[0]:
        raise ValueError("tri_inv: L and Wd batch sizes differ")
    if not L.is_cuda:
        return tri_inv_plain(L3, Wd4).reshape(L.shape)
    L3, Wd4 = L3.contiguous(), Wd4.contiguous()
    cuda.require_cuda("tri_inv", L3, Wd4)
    W = torch.empty_like(L3)  # the kernel writes every element of W
    if L3.shape[0] and n:
        T = torch.empty_like(L3)  # scratch for the products L21 W11
        _TRI.call("ff_tri_inv", L3.data_ptr(), Wd4.data_ptr(), W.data_ptr(), T.data_ptr(),
                  L3.shape[0], n, cuda.stream_ptr(L3.device))
        TRI_INV_LAUNCHES.launches += 1
    return W.reshape(L.shape)


def _pad_identity(A: torch.Tensor, n_pad: int) -> torch.Tensor:
    """[[A, 0], [0, I]] of size n_pad (leading batch kept)."""
    n = A.shape[-1]
    if n_pad == n:
        return A
    out = A.new_zeros(A.shape[:-2] + (n_pad, n_pad))
    out[..., :n, :n] = A
    out.diagonal(dim1=-2, dim2=-1)[..., n:] = 1.0
    return out


def chol_inv_padded(Sigma: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, W = inv(L)) for SPD ``Sigma`` of any n: identity-padded to a
    multiple of `PANEL`, factored (K2/K3a, then K3b), cropped.
    inv([[L, 0], [0, I]]) = [[inv(L), 0], [0, I]], so cropping is exact."""
    n = Sigma.shape[-1]
    L, Wd = chol_inv(_pad_identity(Sigma, -(-n // PANEL) * PANEL))
    return L[..., :n, :n], tri_inv(L, Wd)[..., :n, :n]
