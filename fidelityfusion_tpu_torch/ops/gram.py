"""K1: the fused SE / ARD Gram with its nugget (`csrc/gram.cu`).

    out[..., i, j] = sv * exp(-0.5 * sum_k ((x1[i,k] - x2[j,k]) * inv_ls[k])^2)
                     + (i == j) * (diag_add + y_var[i])

``x1 (n1, d)`` and ``x2 (n2, d)`` are shared by every restart; ``inv_ls
(*batch, d)`` (or ``(*batch, 1)``: one length scale for every dimension),
``sv (*batch)``, ``diag_add (*batch)`` and ``y_var (*batch, n1)`` carry an
optional leading batch (the restart axis).  The output is
``(*batch, n1, n2)``.  ``diag_add``/``y_var`` act on i == j, so they are for
square training Grams; pass neither for a cross-Gram.

`gram` launches the kernel on CUDA tensors (float32, or float64: the
Kronecker path's Grams, `models/hogp.py`) and runs `gram_plain` on CPU
tensors.  Its backward is the VJP of `gram_plain` written out in O(n1 n2)
memory (one n1 x n2 temporary per input dimension, never an n1 n2 d
tensor), with exp(-d2/2) from the kernel again on CUDA tensors (one more
K1 launch) and from `gram_plain` on CPU ones; the Pallas kernel it
replaces had no backward either.
"""

from __future__ import annotations

from typing import Optional

import torch

from fidelityfusion_tpu_torch.ops import cuda

_ARGS = [cuda.PTR] * 7 + [cuda.INT] * 4 + [cuda.PTR]
_LIB = cuda.Library("gram.cu", {"ff_gram": _ARGS, "ff_gram_f64": _ARGS})
_ENTRY = {torch.float32: "ff_gram", torch.float64: "ff_gram_f64"}
LAUNCHES = cuda.counter("gram")


def gram_plain(x1, x2, inv_ls, sv, diag_add=None, y_var=None):
    """Plain PyTorch version of the kernel, same arithmetic order: inputs
    scaled by 1/length-scale, squared differences summed over d, then the
    exponential and the diagonal terms.  Batched (B, ...) arguments."""
    x1s = x1[None] * inv_ls[:, None, :]  # (B, n1, d)
    x2s = x2[None] * inv_ls[:, None, :]  # (B, n2, d)
    d2 = None
    for k in range(x1.shape[-1]):
        diff = x1s[:, :, k, None] - x2s[:, None, :, k]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    if d2 is None:  # d == 0
        d2 = x1.new_zeros((inv_ls.shape[0], x1.shape[0], x2.shape[0]))
    out = sv[:, None, None] * torch.exp(-0.5 * d2)
    if diag_add is not None or y_var is not None:
        extra = torch.zeros(out.shape[:2], dtype=out.dtype, device=out.device)
        if diag_add is not None:
            extra = extra + diag_add[:, None]
        if y_var is not None:
            extra = extra + y_var
        m = min(out.shape[1], out.shape[2])
        out = out.clone()
        out.diagonal(dim1=1, dim2=2).add_(extra[:, :m])
    return out


def _gram_cuda(x1, x2, inv_ls, sv, diag_add, y_var):
    if x1.dtype not in _ENTRY:
        raise ValueError(f"gram: the kernel takes float32 or float64, got {x1.dtype}")
    cuda.require_cuda("gram", x1, x2, inv_ls, sv, diag_add, y_var, dtype=x1.dtype)
    B, d = inv_ls.shape
    n1, n2 = x1.shape[0], x2.shape[0]
    if x1.shape[1] != d or x2.shape[1] != d:
        raise ValueError(f"gram: x1 {tuple(x1.shape)}, x2 {tuple(x2.shape)} vs d={d}")
    if sv.shape != (B,) or (diag_add is not None and diag_add.shape != (B,)):
        raise ValueError("gram: sv and diag_add must have shape (B,)")
    if y_var is not None and y_var.shape != (B, n1):
        raise ValueError(f"gram: y_var must have shape ({B}, {n1})")
    out = torch.empty((B, n1, n2), dtype=x1.dtype, device=x1.device)
    if out.numel() == 0:
        return out
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _LIB.call(_ENTRY[x1.dtype], ptr(x1), ptr(x2), ptr(inv_ls), ptr(sv), ptr(diag_add),
              ptr(y_var), ptr(out), B, n1, n2, d, cuda.stream_ptr(x1.device))
    LAUNCHES.launches += 1
    return out


class _Gram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x1, x2, inv_ls, sv, diag_add, y_var):
        ctx.save_for_backward(x1, x2, inv_ls, sv)
        ctx.has_diag = (diag_add is not None, y_var is not None)
        if x1.is_cuda:
            return _gram_cuda(x1, x2, inv_ls, sv, diag_add, y_var)
        return gram_plain(x1, x2, inv_ls, sv, diag_add, y_var)

    @staticmethod
    def backward(ctx, g):
        x1, x2, inv_ls, sv = ctx.saved_tensors
        need = ctx.needs_input_grad
        # exp(-d2/2): K1 itself on the card (sv = 1, no diagonal terms)
        ones = torch.ones_like(sv)
        E = (_gram_cuda(x1, x2, inv_ls, ones, None, None) if x1.is_cuda
             else gram_plain(x1, x2, inv_ls, ones))
        g_sv = (g * E).sum((1, 2)) if need[3] else None
        H = g * E * sv[:, None, None]  # g * K
        g_ls = g_x1 = g_x2 = None
        if need[2]:
            cols = []
            for k in range(x1.shape[1]):
                delta = x1[:, k, None] - x2[None, :, k]
                cols.append(-inv_ls[:, k] * (H * (delta * delta)).sum((1, 2)))
            g_ls = torch.stack(cols, dim=-1)
        s2 = inv_ls * inv_ls  # (B, d)
        if need[0]:
            g_x1 = (-s2[:, None, :] * (x1[None] * H.sum(2)[..., None] - H @ x2)).sum(0)
        if need[1]:
            Ht = H.transpose(1, 2)
            g_x2 = (s2[:, None, :] * (Ht @ x1 - x2[None] * Ht.sum(2)[..., None])).sum(0)
        m = min(g.shape[1], g.shape[2])
        gdiag = g.diagonal(dim1=1, dim2=2)[:, :m]
        g_da = gdiag.sum(-1) if (ctx.has_diag[0] and need[4]) else None
        g_yv = None
        if ctx.has_diag[1] and need[5]:
            g_yv = torch.zeros(g.shape[:2], dtype=g.dtype, device=g.device)
            g_yv[:, :m] = gdiag
        return g_x1, g_x2, g_ls, g_sv, g_da, g_yv


def gram(x1: torch.Tensor, x2: torch.Tensor, inv_ls: torch.Tensor,
         sv: torch.Tensor, diag_add: Optional[torch.Tensor] = None,
         y_var: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1 wrapper: see the module docstring for shapes.  Differentiable in
    every argument."""
    batch = sv.shape
    B = sv.numel()
    if inv_ls.shape[-1] == 1 and x1.shape[-1] != 1:
        # one length scale for every input dimension (HOGP's shared kernel):
        # expanded here, so its gradient is the sum over the d columns
        inv_ls = inv_ls.expand(inv_ls.shape[:-1] + (x1.shape[-1],))
    args = [inv_ls.reshape(B, -1), sv.reshape(B)]
    args.append(None if diag_add is None
                else diag_add.expand(batch).reshape(B))
    args.append(None if y_var is None
                else y_var.expand(batch + (x1.shape[0],)).reshape(B, -1))
    if x1.is_cuda:
        args = [None if a is None else a.contiguous() for a in args]
        x1, x2 = x1.contiguous(), x2.contiguous()
    out = _Gram.apply(x1, x2, *args)
    return out.reshape(batch + out.shape[1:])
