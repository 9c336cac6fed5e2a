#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`fidelityfusion_tpu_torch`) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout, one H100

Phases, each of which must pass (the script exits non-zero otherwise and
prints no result line):

1. build the hand-written kernels from `fidelityfusion_tpu_torch/csrc`
   (one `nvcc` per source, all started together);
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, and time kernel, plain version, the one library
   call that computes the same function, and the bound from shapes (K1
   and K3b by device time, from a CUDA graph of their calls; K2/K3a by
   CUDA events over back-to-back calls, each longer than its enqueue);
   K1 also at NAR's d = 2 (its stages i >= 1 train on [x, y_low]), at
   the Kronecker path's d = 4 (the Poisson source parameters) and in
   float64 (the Kronecker path's Grams), and at the BO loop's shapes
   (32-row stage Grams, the 32 x 16 cross-Gram and its x-gradient, and
   the continuous loop's d = 3: an 18-row Gram and the 18 x 8 cross-Gram
   with its x-gradient), and at the sweep grid's widest zoo input, d = 10
   (a (4, 100) Gram and the 100 x 100 cross-Gram, the chunked path), and
   on the sharding layer's row slabs (a 1024 x 4096 float32 cross-Gram at
   d = 2, the (2, 2) mesh's batched slab of 2 restarts, 1024 x 2048 at
   d = 2, a 256 x 1024 float64 K0 slab at d = 4); every K2/K3a shape's
   NLML, over 64 Grams, against float64 within twice the plain float32
   version's error; K2
   and K3a also at one 64-row panel, full and
   holding a 32-row Sigma (the BO loop's padded stages), each over 64
   Grams against the plain version in float64, within twice the plain
   float32 version's error; K2 also
   at CAR-large's n = 1792, K3a at (4, 2048) and (2, 1024) (phase 11's
   restart groups on the (1, 1) and (2, 2) meshes); K3b at every K3a shape and at n = 64, 1024, 1792 and 2048; for
   K2/K3a also time the leaf alone; factor ill-conditioned SE
   Grams (relative nugget 1e-6) through K2/K3a and K3b against the plain
   versions in float32 and float64, and a batch with a negative pivot,
   whose factor, inverse and NLML must come out NaN while the other
   matrices' do not; time the Kronecker path's library calls
   (`torch.linalg.eigh`, a `jacobi_refine` sweep, the hogp1024
   mode-product chain);
3. the main path: `train_AR` of a 3-fidelity AR cascade over SE CIGPs
   with 4 restarts on nested (1024, 512, 256)-row subsets of the toy sin,
   then `forward` and `export_posterior` on 1000 test points; every
   kernel must have launched in this phase;
4. the other cascades on the same data, each driven with the launch
   counts set to 0 just before it and read just after: ResGP and NAR
   (SE, then `forward` and `export_posterior`) and staged CAR (ARD) as
   the main path, CAR-large (a 60-step joint fit over all 1792 rows) and
   FIDES (a 60-step fit to 1024 top-fidelity rows); each stage's NLML is
   held against the plain versions in float32 and float64;
5. the Kronecker path, each driven alike: HOGP at the JAX bench's
   shipping shape (n = 1024, output (32, 32, 32), 130 tracked steps:
   residual < 0.30, tracked vs exact NLML, NLML vs the plain float64
   one); GAR over ARD
   HOGPs on Poisson fields at resolutions (8, 16, 32) with d_in = 4 on
   the nested `SIZES` rows, 4 restarts (stages 0 and 1 tracked, stage 2
   exact eigh), `forward` on 128 test samples (relative error < 0.6);
   CIGAR on the same data (K1/K2/K3a/K3b); a NaN restart isolated;
6. joint and legacy training, each path driven alike: `train_joint` of
   AR, ResGP, NAR (SE) and staged CAR (ARD) on the main path's data, of
   AR, ResGP and NAR non-subset on independent designs at `SIZES` rows
   (4 rounds of imputation), of GAR and CIGAR on phase 5's fields and
   non-subset (3 rounds), then `forward` (RMSE < 0.35, CAR < 0.5;
   relative error < 0.6, non-subset < 0.8; each stage's NLML against the
   plain versions); `LegacyCIGP` (100 steps, 1024 rows), `LegacyHOGP`
   (`compute_loss` and `forward` on GAR's stage-0 fields), `LegacyFIDES`
   (60 steps); `CIGP(x64_factor=True)` at n = 1024 against a numpy
   float64 NLML to 1e-10, with no kernel launched in it;
7. the unbatched paths: a 20-step SE CIGP fit at n = 2048 (`se_nlml`) and
   an ARD fit (`mvn_nll_hybrid`);
8. multi-fidelity BO, each run driven alike: `mf_bo_discrete` on
   Forrester(2) with the AR surrogate, 10 iterations from the {1: 10,
   2: 4} design at the loop's defaults (UCB on seeds 0, 1, 2; EI, ES and
   cfKG on seed 0): incumbents never decrease, cost grows, every value
   finite, K1, K2, K3a and K3b launched in each run, the final incumbent
   >= 15.0 (UCB: the median of the seeds); `mf_bo_continuous` on Branin
   (UCB, ES, KG; K1, K2 and K3b launched in each); one UCB iteration on the card against ``device="cpu"``
   (the same fidelity, the CPU's acquisition at the card's x within 1e-3
   of its best); ms per acquisition Adam step (K1 forward and backward a
   stage a step, `gram_plain` never called) and the `ARPosterior` query
   latency at 16 and 1000 points;
9. the experiments, each method's sweep driven alike: the grid protocol
   (`experiments/sweep.py:run_sweep`) on forrester12, seed 0, n_high 4, 8,
   16, 32 at the harness's defaults (100 low rows, 100 test points, 200
   steps, 4 restarts, lr 5e-2; CAR at `train_CAR`'s 1e-2, where its
   restarts settle) for AR, ResGP, NAR, CAR, GAR and CIGAR,
   CSVs to a temporary directory (header, 4 rows, every metric finite;
   K1, K3a and K3b launched, GAR K1), the RMSE at n_high 16 and 32 within
   1.25 x the JAX harness's + 0.01 std(y_test) (`SWEEP_JAX_RMSE`, from
   `scripts/sweep_jax_bars.py`), the AR cell at n_high 32 again with
   ``device="cpu"`` (RMSE within 5%); the field protocol
   (`run_gar_field_sweep`, GAR and CIGAR on Poisson, non-aligned,
   resolutions (8, 16), n_high 8 and 32, the same bar at 32);
   `MLPTrainingObjective(2)` and `CNNTrainingObjective(2)` at 4
   hyperparameter rows and s = 1, 2 on the card against
   ``device="cpu"`` (accuracies within 1/n_val, validation logits within
   1e-3 of their max), ms per `get_data` row; `mf_bo_discrete` on the MLP
   objective (AR, 5 iterations; incumbents in [0, 1] never fall, cost
   grows, K1, K2, K3a and K3b launched);
10. the device kernels of one K2/K3a call and one K3b call, under
   `torch.profiler` (last: tracing slows every launch after it).
11. the sharding layer (`fidelityfusion_tpu_torch/parallel/`), run before
   phase 10, each run
   driven alike and holding that K1, K2 or K3a and K3b launched (K1 alone
   on the Kronecker path, which factors by `eigh`) while the plain
   versions were called 0 times: (a) a world of one rank over NCCL, the
   JAX package's one-chip mode: `cigp_nll_nsharded` value and gradient at
   n = 2048 (ARD, d_in = 2) against the unsharded `CIGP.nll` (1e-3 of
   max(1, |v|), 2e-3 a gradient leaf), `fit_nsharded` 20 steps (finite,
   falling), `cigp_posterior_nsharded` on 256 test rows against
   `predict_diag`, `fit_restarts_nsharded` R = 4 on a (1, 1) mesh (K3a at
   (4, 2048)), `train_AR` with `n_mesh` on the main path's data (stage 0
   sharded, RMSE < 0.12), `train_GAR` with `n_mesh` on phase 5's fields
   (stage 0 sharded, relative error < 0.6) and `fit_hogp_nsharded` at
   hogp1024's shape (the step-0 tracked loss within 2e-4 of
   `nll_tracked`, its gradient within 5e-3 a leaf), each one's ms per step beside the unsharded path's in
   this call; (b) 4 ranks on the one card over gloo, spawned by the phase
   (this script with ``--sharding-rank``; the card's compute mode printed,
   since cooperative launches need time-slicing, not MPS):
   `cigp_nll_nsharded` at n = 4096 (1024-row blocks) against a float64
   plain NLML and gradient, `restarts_nll_nsharded` on a (2, 2) mesh at
   n = 2048 with the AR rho residual against float64 per restart, and
   `hogp_nll_tracked_nsharded` at n = 1024, output (32, 32, 32), against
   the unsharded `nll_tracked`, and in float64 against the exact float64
   NLML (value 1e-9, each gradient leaf 1e-8), both float32 gradients
   against float64 (5e-3 a leaf); every rank's exit code, launches and
   value are checked;

The second-to-last line is `{"kernels": [...]}`, the last
`{"ok": true, "device": {...}}`.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

PEAK_FP32_FLOPS = 67e12   # H100 SXM, fp32 without tensor cores (data sheet)
PEAK_FP64_FLOPS = 34e12   # H100 SXM, fp64 without tensor cores (data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 (data sheet)
NOISE = 1e-2              # SE Grams of the kernel checks: noise 1e-2
SIZES = (1024, 512, 256)  # main path: rows of the three fidelities
FIT_STEPS = 60            # CAR-large's and FIDES's unbatched fits
FAILURES = []


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        FAILURES.append(what)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def timed(fn, torch, budget_s: float = 0.3, max_iters: int = 50) -> float:
    """Mean milliseconds per call from CUDA events, after a warm-up call,
    over as many calls as fit in ``budget_s`` (at least 1)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t
    iters = max(1, min(max_iters, int(budget_s / max(once, 1e-6))))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, calls: int = 20, reps: int = 5) -> float:
    """Mean device milliseconds per call of ``fn``: ``calls`` calls captured
    in one CUDA graph (their outputs kept, so each writes memory of its
    own), replayed ``reps`` times between CUDA events.  The wrapper's
    Python runs at capture only, so this is the device's time where a
    call's enqueue takes longer than its kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch.cuda.graph asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph, keep = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for _ in range(calls):
            keep.append(fn())
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_FP32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes / HBM rate and
    operations / the peak rate of their type (fp32 unless given)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


class PlainCalls:
    """Counts calls of the plain versions of K1, K2/K3a and K3b while it
    is entered (the wrappers look them up in their modules at call time)."""

    NAMES = (("gram", "gram_plain"), ("chol", "chol_inv_plain"), ("chol", "tri_inv_plain"))

    def __enter__(self):
        from fidelityfusion_tpu_torch.ops import chol, gram

        self.mods = {"gram": gram, "chol": chol}
        self.calls = {name: 0 for _, name in self.NAMES}
        self.saved = []
        for mod, name in self.NAMES:
            real = getattr(self.mods[mod], name)
            self.saved.append((mod, name, real))

            def counted(*a, _name=name, _real=real, **k):
                self.calls[_name] += 1
                return _real(*a, **k)

            setattr(self.mods[mod], name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(self.mods[mod], name, real)


def nll_of(torch, L, W, y):
    """NLML of y ~ N(0, L L^T) from L and W = inv(L), batched."""
    from fidelityfusion_tpu_torch.ops.linalg import LOG2PI

    gamma = W @ y
    return (0.5 * (gamma * gamma).sum((-2, -1))
            + torch.log(L.diagonal(dim1=-2, dim2=-1)).sum(-1) + 0.5 * L.shape[-1] * LOG2PI)


def device_ops_per_call(torch, fn) -> int:
    """Device kernels and copies that one call of ``fn`` issues, from
    `torch.profiler` (after a warm-up call)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def leaf_us(torch, device, reps: int = 200) -> float:
    """Microseconds of K2/K3a's 64x64 leaf alone: (time of reps + 1
    factorizations inside one launch - time of 1) / reps."""
    from fidelityfusion_tpu_torch.ops.chol import chol_leaf

    D = se_gram(torch, 1, 64, torch.Generator().manual_seed(3), device)
    t1 = timed(lambda: chol_leaf(D, reps=1), torch)
    tn = timed(lambda: chol_leaf(D, reps=reps + 1), torch)
    return (tn - t1) / reps * 1e3


def se_gram(torch, R, n, gen, device):
    """(R, n, n) SE Grams at noise `NOISE` on the toy inputs of `se_problem`."""
    from fidelityfusion_tpu_torch.ops.gram import gram_plain

    x, inv_ls, sv, da = se_problem(torch, R, n, 1, gen, device)
    return gram_plain(x, x, inv_ls, sv, da)


def se_problem(torch, R, n, d, gen, device):
    """Toy inputs (standardized) and per-restart SE parameters on the card."""
    x = torch.randn((n, d), generator=gen).to(device)
    inv_ls = torch.exp(-torch.linspace(-1.5, 0.5, R))[:, None].expand(R, d).contiguous().to(device)
    sv = torch.linspace(0.5, 2.0, R).to(device)
    return x, inv_ls, sv, torch.full((R,), NOISE, device=device)


def gram_d2_checks(torch, device, gen, library_gram):
    """K1 at NAR's stages i >= 1 ([x, y_low], d = 2): the training Grams at
    (4, 512) and (4, 256) with nugget and y_var, the 512 x 1000 cross-Gram
    of predict, against the plain version; (4, 512) timed by device time
    beside its bound, plain version and `cdist`."""
    from fidelityfusion_tpu_torch.ops import gram as G

    errs = []
    for n in (512, 256):
        x, inv_ls, sv, da = se_problem(torch, 4, n, 2, gen, device)
        yv = (0.01 * torch.rand((4, n), generator=gen)).to(device)
        got, want = G.gram(x, x, inv_ls, sv, diag_add=da, y_var=yv), G.gram_plain(
            x, x, inv_ls, sv, da, yv)
        err = (got - want).abs()
        errs.append(err.max().item())
        check(bool((err <= 1e-5 + 1e-4 * want.abs()).all())
              and bool((got.diagonal(dim1=1, dim2=2) == (sv + da)[:, None] + yv).all()),
              f"K1 gram R=4 n={n} d=2 (y_var): max abs err {err.max().item():.3e} "
              f"(rtol 1e-4, atol 1e-5), diagonal exact")
        if n == 512:
            timed_args = (x, inv_ls, sv, da, yv)
    x, inv_ls, sv, da, yv = timed_args
    xt = torch.randn((1000, 2), generator=gen).to(device)
    got_c, want_c = G.gram(x, xt, inv_ls, sv), G.gram_plain(x, xt, inv_ls, sv)
    err_c = (got_c - want_c).abs()
    check(bool((err_c <= 1e-5 + 1e-4 * want_c.abs()).all()),
          f"K1 cross-gram 512x1000 d=2: max abs err {err_c.max().item():.3e}")
    R, n, d = 4, 512, 2
    ms = device_ms(torch, lambda: G.gram(x, x, inv_ls, sv, diag_add=da, y_var=yv))
    plain_ms = device_ms(torch, lambda: G.gram_plain(x, x, inv_ls, sv, da, yv))
    lib_ms = device_ms(torch, lambda: library_gram(x, x, inv_ls, sv, da)
                       + torch.diag_embed(yv))
    b_ms, b_by = bound(R * n * n * (3 * d + 3), 4 * (2 * n * d + R * (d + 2) + R * n + R * n * n))
    print(f"K1 R={R} n={n} d={d}: kernel {ms * 1e3:.3f} us by device time  plain "
          f"{plain_ms * 1e3:.3f} us  cdist {lib_ms * 1e3:.3f} us  bound {b_ms * 1e3:.3f} us "
          f"({b_by})", flush=True)
    return dict(shape=f"R={R} n={n} d={d}", ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, max_abs_err=max(errs),
                cross_max_abs_err=err_c.max().item())


def gram_d4_checks(torch, device, gen, library_gram):
    """K1 at the Kronecker path's d = 4 (the Poisson source parameters of
    every HOGP, GAR and CIGAR stage): the (4, 1024) training Gram with the
    jitter nugget and the 128 x 1024 cross-Gram of `predict`, against the
    plain version; the square one timed by device time beside its bound,
    plain version and `cdist`.  The length scales go in as (R, 4), so a
    tree whose wrapper does not broadcast a dim-1 scale times the same
    call (the dim-1 scale is checked in the Kronecker phase)."""
    from fidelityfusion_tpu_torch.ops import gram as G

    R, n, d, m = 4, 1024, 4, 128
    x = torch.rand((n, d), generator=gen).to(device)
    inv_ls = (0.5 + torch.rand((R, d), generator=gen)).to(device)
    sv = torch.linspace(0.5, 2.0, R).to(device)
    da = torch.full((R,), 1e-6, device=device)
    got, want = G.gram(x, x, inv_ls, sv, diag_add=da), G.gram_plain(x, x, inv_ls, sv, da)
    err = (got - want).abs()
    check(bool((err <= 1e-5 + 1e-4 * want.abs()).all())
          and bool((got.diagonal(dim1=1, dim2=2) == (sv + da)[:, None]).all()),
          f"K1 gram R={R} n={n} d={d} (jitter nugget): max abs err {err.max().item():.3e} "
          f"(rtol 1e-4, atol 1e-5), diagonal exact")
    xt = torch.rand((m, d), generator=gen).to(device)
    got_c, want_c = G.gram(xt, x, inv_ls, sv), G.gram_plain(xt, x, inv_ls, sv)
    err_c = (got_c - want_c).abs()
    check(bool((err_c <= 1e-5 + 1e-4 * want_c.abs()).all()),
          f"K1 cross-gram {m}x{n} d={d}: max abs err {err_c.max().item():.3e}")
    ms = device_ms(torch, lambda: G.gram(x, x, inv_ls, sv, diag_add=da))
    plain_ms = device_ms(torch, lambda: G.gram_plain(x, x, inv_ls, sv, da))
    lib_ms = device_ms(torch, lambda: library_gram(x, x, inv_ls, sv, da))
    cross_ms = device_ms(torch, lambda: G.gram(xt, x, inv_ls, sv))
    cross_plain_ms = device_ms(torch, lambda: G.gram_plain(xt, x, inv_ls, sv))
    cross_lib_ms = device_ms(torch, lambda: library_gram(xt, x, inv_ls, sv))
    b_ms, b_by = bound(R * n * n * (3 * d + 3), 4 * (2 * n * d + R * (d + 2) + R * n * n))
    bc_ms, _ = bound(R * m * n * (3 * d + 2), 4 * ((n + m) * d + 2 * R + R * m * n))
    print(f"K1 R={R} n={n} d={d}: kernel {ms * 1e3:.3f} us by device time  plain "
          f"{plain_ms * 1e3:.3f} us  cdist {lib_ms * 1e3:.3f} us  bound {b_ms * 1e3:.3f} us "
          f"({b_by}); cross-Gram {m}x{n} {cross_ms * 1e3:.3f} us (bound {bc_ms * 1e3:.3f} us, "
          f"plain {cross_plain_ms * 1e3:.3f} us, cdist {cross_lib_ms * 1e3:.3f} us)", flush=True)
    return dict(shape=f"R={R} n={n} d={d}", ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, max_abs_err=err.max().item(),
                cross_shape=f"R={R} {m}x{n} d={d}", cross_ms=cross_ms, cross_bound_ms=bc_ms,
                cross_plain_ms=cross_plain_ms, cross_library_ms=cross_lib_ms,
                cross_max_abs_err=err_c.max().item())


def gram_bo_checks(torch, device, gen, library_gram):
    """K1 at the BO loop's shapes (Forrester, d = 1): a stage's training Gram
    of 4 restarts at 32 padded rows with its nugget, and the cross-Gram of
    an acquisition step (32 training rows x 16 starts) with its gradient in
    the starts (the backward's own K1 launch), against the plain version;
    both timed by device time beside bound, plain version and `cdist`."""
    from fidelityfusion_tpu_torch.ops import gram as G

    R, n, m = 4, 32, 16
    x, inv_ls, sv, da = se_problem(torch, R, n, 1, gen, device)
    got, want = G.gram(x, x, inv_ls, sv, diag_add=da), G.gram_plain(x, x, inv_ls, sv, da)
    err = (got - want).abs()
    check(bool((err <= 1e-5 + 1e-4 * want.abs()).all()),
          f"K1 gram R={R} n={n} d=1 (BO stage): max abs err {err.max().item():.3e}")
    xs = torch.rand((m, 1), generator=gen).to(device).requires_grad_()
    xp = xs.detach().clone().requires_grad_()
    Kc, Kp = G.gram(x, xs, inv_ls[:1], sv[:1]), G.gram_plain(x, xp, inv_ls[:1], sv[:1])
    (g,), (gp,) = (torch.autograd.grad(K.sum(), v) for K, v in ((Kc, xs), (Kp, xp)))
    err_c = max((Kc - Kp).abs().max().item(), (g - gp).abs().max().item())
    check(bool(((Kc - Kp).abs() <= 1e-5 + 1e-4 * Kp.abs()).all())
          and bool(((g - gp).abs() <= 1e-5 + 1e-4 * gp.abs()).all()),
          f"K1 cross-gram {n}x{m} d=1 and its x-gradient (BO acquisition): max abs err "
          f"{err_c:.3e}")
    xd = xs.detach()
    err3, ms3, plain_ms3, b3_ms, b3_by, lib_ms3 = gram_bo_d3_checks(torch, device, gen,
                                                                     library_gram)
    ms = device_ms(torch, lambda: G.gram(x, x, inv_ls, sv, diag_add=da))
    plain_ms = device_ms(torch, lambda: G.gram_plain(x, x, inv_ls, sv, da))
    lib_ms = device_ms(torch, lambda: library_gram(x, x, inv_ls, sv, da))
    cross_ms = device_ms(torch, lambda: G.gram(x, xd, inv_ls[:1], sv[:1]))
    cross_plain_ms = device_ms(torch, lambda: G.gram_plain(x, xd, inv_ls[:1], sv[:1]))
    cross_lib_ms = device_ms(torch, lambda: library_gram(x, xd, inv_ls[:1], sv[:1]))
    b_ms, b_by = bound(R * n * n * 6, 4 * (2 * n + R * 3 + R * n * n))
    bc_ms, _ = bound(n * m * 5, 4 * (n + m + 2 + n * m))
    print(f"K1 R={R} n={n} d=1 (BO stage): kernel {ms * 1e3:.3f} us by device time  plain "
          f"{plain_ms * 1e3:.3f} us  cdist {lib_ms * 1e3:.3f} us  bound {b_ms * 1e3:.4f} us "
          f"({b_by}); cross-Gram {n}x{m} {cross_ms * 1e3:.3f} us (bound {bc_ms * 1e3:.4f} us, "
          f"plain {cross_plain_ms * 1e3:.3f} us, cdist {cross_lib_ms * 1e3:.3f} us)", flush=True)
    return dict(shape=f"R={R} n={n} d=1", ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, max_abs_err=err.max().item(),
                cross_shape=f"{n}x{m} d=1", cross_ms=cross_ms, cross_bound_ms=bc_ms,
                cross_plain_ms=cross_plain_ms, cross_library_ms=cross_lib_ms,
                cross_max_abs_err=err_c, d3_shape="n=18 d=3, cross 18x8", d3_ms=ms3,
                d3_plain_ms=plain_ms3, d3_max_abs_err=err3, d3_bound_ms=b3_ms,
                d3_bound_by=b3_by, d3_library_ms=lib_ms3)


def gram_bo_d3_checks(torch, device, gen, library_gram):
    """K1 at the continuous BO loop's shapes: FIDES trains on the joint
    (x, z) input of Branin, d = 3, so K1 runs its chunked path (not the
    register path of d = 1, 2, 4).  An unbatched training Gram of 18 rows
    (the loop's 8 initial points and 10 iterations) with its noise nugget,
    and the cross-Gram against the UCB ascent's 8 starts at z = 1 with its
    gradient in the starts, against the plain version at rtol 1e-4, atol
    1e-5.  Returns (max abs err, kernel ms, plain ms, bound ms, bound by,
    `cdist` ms) of the training Gram, by device time."""
    from fidelityfusion_tpu_torch.ops import gram as G

    n, m = 18, 8
    box = torch.tensor([[-5.0, 10.0], [0.0, 15.0], [0.1, 1.0]])  # Branin's x, then z
    x = (box[:, 0] + torch.rand((n, 3), generator=gen) * (box[:, 1] - box[:, 0])).to(device)
    xs = (box[:, 0] + torch.rand((m, 3), generator=gen) * (box[:, 1] - box[:, 0]))
    xs[:, 2] = 1.0
    xs = xs.to(device).requires_grad_()
    xp = xs.detach().clone().requires_grad_()
    inv_ls = (0.1 + 0.4 * torch.rand((3,), generator=gen)).to(device)
    sv, da = torch.tensor(1.3, device=device), torch.tensor(NOISE, device=device)
    close = lambda a, b: bool(((a - b).abs() <= 1e-5 + 1e-4 * b.abs()).all())  # noqa: E731
    got = G.gram(x, x, inv_ls, sv, diag_add=da)
    want = G.gram_plain(x, x, inv_ls[None], sv[None], da[None])[0]
    err = (got - want).abs().max().item()
    check(got.shape == (n, n) and close(got, want),
          f"K1 gram n={n} d=3 (continuous BO, FIDES on (x, z)): max abs err {err:.3e}")
    Kc, Kp = G.gram(x, xs, inv_ls, sv), G.gram_plain(x, xp, inv_ls[None], sv[None])[0]
    (g,), (gp,) = (torch.autograd.grad(K.sum(), v) for K, v in ((Kc, xs), (Kp, xp)))
    err_c = max((Kc - Kp).abs().max().item(), (g - gp).abs().max().item())
    check(close(Kc, Kp) and close(g, gp),
          f"K1 cross-gram {n}x{m} d=3 and its x-gradient (continuous UCB ascent): max abs err "
          f"{err_c:.3e}")
    ms = device_ms(torch, lambda: G.gram(x, x, inv_ls, sv, diag_add=da))
    plain_ms = device_ms(torch, lambda: G.gram_plain(x, x, inv_ls[None], sv[None], da[None]))
    lib_ms = device_ms(torch, lambda: library_gram(x, x, inv_ls[None], sv[None], da[None]))
    b_ms, b_by = bound(n * n * (3 * 3 + 3), 4 * (2 * n * 3 + (3 + 2) + n * n))
    print(f"K1 n={n} d=3 (continuous BO): kernel {ms * 1e3:.3f} us by device time  plain "
          f"{plain_ms * 1e3:.3f} us  cdist {lib_ms * 1e3:.3f} us  bound {b_ms * 1e3:.5f} us "
          f"({b_by})", flush=True)
    return max(err, err_c), ms, plain_ms, b_ms, b_by, lib_ms


def gram_wide_checks(torch, device, gen, library_gram):
    """K1 at the sweep grid's widest zoo input, d = 10 (`toal`, `shuo16`;
    the chunked path): a restart batch of training Grams at the harness's
    100 low-fidelity rows with the noise nugget, and the 100 x 100
    cross-Gram of the test forward, against the plain version at rtol
    1e-4, atol 1e-5; the square one timed by device time beside its
    bound, plain version and `cdist`."""
    from fidelityfusion_tpu_torch.ops import gram as G

    R, n, d, m = 4, 100, 10, 100
    x = torch.randn((n, d), generator=gen).to(device)
    inv_ls = (0.1 + 0.5 * torch.rand((R, d), generator=gen)).to(device)
    sv = torch.linspace(0.5, 2.0, R).to(device)
    da = torch.full((R,), NOISE, device=device)
    close = lambda a, b: bool(((a - b).abs() <= 1e-5 + 1e-4 * b.abs()).all())  # noqa: E731
    got, want = G.gram(x, x, inv_ls, sv, diag_add=da), G.gram_plain(x, x, inv_ls, sv, da)
    err = (got - want).abs().max().item()
    check(close(got, want) and bool((got.diagonal(dim1=1, dim2=2) == (sv + da)[:, None]).all()),
          f"K1 gram R={R} n={n} d={d} (sweep grid, widest zoo input): max abs err {err:.3e} "
          f"(rtol 1e-4, atol 1e-5), diagonal exact")
    xt = torch.randn((m, d), generator=gen).to(device)
    got_c, want_c = G.gram(x, xt, inv_ls[:1], sv[:1]), G.gram_plain(x, xt, inv_ls[:1], sv[:1])
    err_c = (got_c - want_c).abs().max().item()
    check(close(got_c, want_c), f"K1 cross-gram {n}x{m} d={d}: max abs err {err_c:.3e}")
    ms = device_ms(torch, lambda: G.gram(x, x, inv_ls, sv, diag_add=da))
    plain_ms = device_ms(torch, lambda: G.gram_plain(x, x, inv_ls, sv, da))
    lib_ms = device_ms(torch, lambda: library_gram(x, x, inv_ls, sv, da))
    b_ms, b_by = bound(R * n * n * (3 * d + 3), 4 * (2 * n * d + R * (d + 2) + R * n * n))
    print(f"K1 R={R} n={n} d={d} (chunked path): kernel {ms * 1e3:.3f} us by device time  "
          f"plain {plain_ms * 1e3:.3f} us  cdist {lib_ms * 1e3:.3f} us  bound "
          f"{b_ms * 1e3:.4f} us ({b_by})", flush=True)
    return dict(shape=f"R={R} n={n} d={d}", ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, max_abs_err=max(err, err_c))


def gram_f64_checks(torch, device, gen, library_gram):
    """K1's float64 instance, the Kronecker path's Grams (HOGP's and GAR's
    K_0 with the jitter nugget at (4, 1024) and d = 4, a 32-point mode
    Gram at d = 1), against the plain version in float64 (rtol 1e-12, the
    diagonal exact); the square one timed by device time beside its bound,
    plain version and a float64 `cdist`."""
    from fidelityfusion_tpu_torch.ops import gram as G

    f64 = torch.float64
    R, n, d = 4, 1024, 4
    x = torch.rand((n, d), generator=gen, dtype=f64).to(device)
    inv_ls = (0.5 + torch.rand((R, d), generator=gen, dtype=f64)).to(device)
    sv = torch.linspace(0.5, 2.0, R, dtype=f64).to(device)
    da = torch.full((R,), 1e-6, dtype=f64, device=device)
    g = torch.arange(32, dtype=f64, device=device).reshape(-1, 1)
    errs = []
    for label, args in ((f"R={R} n={n} d={d} (jitter nugget)", (x, x, inv_ls, sv, da)),
                        ("mode Gram 32x32 d=1", (g, g, inv_ls[:1, :1].contiguous(), sv[:1]))):
        got, want = G.gram(*args[:4], *args[4:]), G.gram_plain(*args)
        err = (got - want).abs()
        errs.append(err.max().item())
        diag = args[3][:, None] + (args[4][:, None] if len(args) > 4 else 0)
        check(got.dtype == f64 and bool((err <= 1e-12 * want.abs() + 1e-15).all())
              and bool((got.diagonal(dim1=1, dim2=2) == diag).all()),
              f"K1 float64 {label}: max abs err {err.max().item():.3e} (rtol 1e-12), "
              f"diagonal exact")
    ms = device_ms(torch, lambda: G.gram(x, x, inv_ls, sv, diag_add=da))
    plain_ms = device_ms(torch, lambda: G.gram_plain(x, x, inv_ls, sv, da))
    lib_ms = device_ms(torch, lambda: library_gram(x, x, inv_ls, sv, da))
    b_ms, b_by = bound(R * n * n * (3 * d + 3), 8 * (2 * n * d + R * (d + 2) + R * n * n),
                       peak_flops=PEAK_FP64_FLOPS)
    print(f"K1 float64 R={R} n={n} d={d}: kernel {ms * 1e3:.3f} us by device time  plain "
          f"{plain_ms * 1e3:.3f} us  cdist {lib_ms * 1e3:.3f} us  bound {b_ms * 1e3:.3f} us "
          f"({b_by})", flush=True)
    return dict(shape=f"float64 R={R} n={n} d={d}", ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, max_abs_err=max(errs))


def kron_timings(torch, device, report):
    """Library calls and GEMM chains of the Kronecker path (no kernel of
    the port; times only, by CUDA events): `torch.linalg.eigh` in float32
    and the port's `eigh_pairs` (float64 inside) at (4, 1024), (1, 1024)
    and (4, 256); one `jacobi_refine` sweep at (4, 1024);
    the forward mode-product chain of hogp1024 (y of (1024, 32, 32, 32)
    through the four eigenbases' transposes)."""
    from fidelityfusion_tpu_torch.ops import kron, spectral
    from fidelityfusion_tpu_torch.ops.gram import gram_plain

    gen = torch.Generator().manual_seed(11)
    out = {}
    for R, n in ((4, 1024), (1, 1024), (4, 256)):
        x = torch.rand((n, 4), generator=gen).to(device)
        K = gram_plain(x, x, torch.full((R, 4), 2.0, device=device),
                       torch.ones(R, device=device), torch.full((R,), 1e-2, device=device))
        out[f"eigh R={R} n={n}"] = timed(lambda: torch.linalg.eigh(K), torch, max_iters=10)
        out[f"eigh_pairs (float64) R={R} n={n}"] = timed(lambda: kron.eigh_pairs(K), torch,
                                                         max_iters=10)
        if (R, n) == (4, 1024):
            _, V = torch.linalg.eigh(K)
            K2 = K * 1.01 + 1e-3 * torch.eye(n, device=device)
            out["jacobi_refine sweep R=4 n=1024"] = timed(
                lambda: spectral.jacobi_refine(K2, V), torch)
            w, V2, res = spectral.jacobi_refine(K2, V)
            check(bool(torch.isfinite(w).all()) and float(res.max()) < 0.1,
                  f"jacobi_refine (4, 1024): finite, residual {float(res.max()):.3e} < 0.1")
    y = torch.rand((1024, 32, 32, 32), generator=gen).to(device)
    Vs = [torch.linalg.qr(torch.randn((d, d), generator=gen))[0].to(device)
          for d in (1024, 32, 32, 32)]
    out["mode-product chain (1024, 32, 32, 32)"] = timed(
        lambda: kron.multi_mode_dot(y, [V.T for V in Vs]), torch)
    for key, ms in out.items():
        print(f"{key}: {ms:.4f} ms (CUDA events)", flush=True)
    report["kron_timings"] = out


def gram_slab_checks(torch, device, library_gram):
    """K1 on the sharding layer's row slabs (phase 11): the cross-Gram
    ``K(x_local, x_full)`` of one of 4 ranks at n = 4096, d = 2 (a 1024 x
    4096 float32 slab, no nugget), the restart group's batched slab of one
    rank of the (2, 2) mesh at n = 2048 (2 restarts of a 1024 x 2048 slab,
    d = 2), and the Kronecker path's float64 K0 slab of one of 4 ranks at
    hogp1024 (256 x 1024, d = 4); each against the plain version (float32:
    rtol 1e-4, atol 1e-5; float64: rtol 1e-12), by device time."""
    from fidelityfusion_tpu_torch.ops.gram import gram, gram_plain

    out = {}
    for label, R, b, n, d, dtype in (
            ("slab 1024x4096 d=2", 1, 1024, 4096, 2, torch.float32),
            ("batched slab R=2 1024x2048 d=2", 2, 1024, 2048, 2, torch.float32),
            ("f64 K0 slab 256x1024 d=4", 1, 256, 1024, 4, torch.float64)):
        g = torch.Generator().manual_seed(19 + d + R)
        x = torch.randn((n, d), generator=g, dtype=dtype).to(device)
        xl = x[b:2 * b].contiguous()  # rank 1's rows
        inv_ls = (torch.rand((R, d), generator=g, dtype=dtype) + 0.5).to(device)
        sv = torch.linspace(1.0, 1.5, R, dtype=dtype, device=device)
        got, want = gram(xl, x, inv_ls, sv), gram_plain(xl, x, inv_ls, sv)
        err = (got - want).abs()
        tol = (1e-12 * want.abs() if dtype == torch.float64
               else 1e-5 + 1e-4 * want.abs())
        check(bool((err <= tol).all()), f"K1 {label}: max abs err {err.max().item():.3e} vs plain")
        ms = device_ms(torch, lambda: gram(xl, x, inv_ls, sv))
        plain_ms = device_ms(torch, lambda: gram_plain(xl, x, inv_ls, sv))
        lib_ms = device_ms(torch, lambda: library_gram(xl, x, inv_ls, sv))
        elt = 8 if dtype == torch.float64 else 4
        b_ms, b_by = bound(R * b * n * (3 * d + 2), elt * ((b + n) * d + R * (d + 1) + R * b * n),
                           PEAK_FP64_FLOPS if dtype == torch.float64 else PEAK_FP32_FLOPS)
        print(f"K1 {label}: kernel {ms * 1e3:.3f} us  plain {plain_ms * 1e3:.3f} us  cdist "
              f"{lib_ms * 1e3:.3f} us  bound {b_ms * 1e3:.3f} us ({b_by}), by device time",
              flush=True)
        out[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                          bound_by=b_by, max_abs_err=err.max().item())
    return out


def nll_floor_check(torch, device, key, R, n):
    """K2 (one matrix a call) or K3a (R a call) with K3b on 64 SE Grams of
    n rows: their error against float64 (`torch.linalg.cholesky` and a
    triangular solve) must stay within twice the plain float32 version's,
    on L (Frobenius, over the 64) and on the NLML (summed over the 64), as
    `panel_checks` holds one panel: the bar is float32's rounding at this
    shape, not a fixed number (one batch's NLML lies at float32's floor
    from the plain version's, `scripts/chol_nll_floor.py`)."""
    from fidelityfusion_tpu_torch.ops.chol import chol_inv, chol_inv_plain, tri_inv, tri_inv_plain
    from fidelityfusion_tpu_torch.ops.gram import gram_plain
    from fidelityfusion_tpu_torch.ops.linalg import LOG2PI

    g = torch.Generator().manual_seed(100 + n + R)  # its own inputs
    x, inv_ls, sv, da = se_problem(torch, 64, n, 1, g, device)
    A = gram_plain(x, x, inv_ls, sv, da)
    y = torch.sin(2.0 * x) + 0.05 * torch.randn((n, 1), generator=g).to(device)
    L64 = torch.linalg.cholesky(A.double())
    gamma = torch.linalg.solve_triangular(L64, y.double().expand(64, n, 1), upper=False)
    v64 = (0.5 * (gamma * gamma).sum((-2, -1)) + torch.log(L64.diagonal(dim1=-2, dim2=-1)).sum(-1)
           + 0.5 * n * LOG2PI)

    def errors(L, W):
        return ((L.double() - L64).norm().item(),
                (nll_of(torch, L, W, y).double() - v64).abs().sum().item())

    Lp, Wdp = chol_inv_plain(A)
    err_L32, err_v32 = errors(Lp, tri_inv_plain(Lp, Wdp))
    del Lp, Wdp
    if key == "K2":
        parts = [chol_inv(a) for a in A]
        L, Wd = torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])
    else:
        parts = [chol_inv(A[i:i + R]) for i in range(0, 64, R)]
        L, Wd = torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    err_L, err_v = errors(L, tri_inv(L, Wd))
    print(f"{key} R={R} n={n}, 64 Grams: |L - L64|_F kernel {err_L:.4e} plain fp32 {err_L32:.4e}; "
          f"sum |NLML - NLML64| kernel {err_v:.4e} plain fp32 {err_v32:.4e} (sum |NLML64| "
          f"{v64.abs().sum().item():.4e})", flush=True)
    check(err_L <= 2 * err_L32 and err_v <= 2 * err_v32,
          f"{key} R={R} n={n}: kernel's error vs fp64 within 2x the plain fp32 version's over 64 "
          f"Grams (L {err_L / err_L32:.3f}x, NLML {err_v / err_v32:.3f}x)")


def kernel_checks(torch, device, report):
    from fidelityfusion_tpu_torch.ops import gram as G
    from fidelityfusion_tpu_torch.ops.chol import (
        chol_inv, chol_inv_plain, tri_inv, tri_inv_plain)

    gen = torch.Generator().manual_seed(0)

    # ---- K1: the training Gram (R=4, n=1024, d=1) and the cross-Gram 1024x1000
    R, n, d = 4, 1024, 1
    x, inv_ls, sv, da = se_problem(torch, R, n, d, gen, device)
    got = G.gram(x, x, inv_ls, sv, diag_add=da)
    want = G.gram_plain(x, x, inv_ls, sv, da)
    err = (got - want).abs()
    check(bool((err <= 1e-5 + 1e-4 * want.abs()).all()),
          f"K1 gram R={R} n={n}: max abs err {err.max().item():.3e} (rtol 1e-4, atol 1e-5)")
    xt = torch.randn((1000, d), generator=gen).to(device)
    got_c, want_c = G.gram(x, xt, inv_ls, sv), G.gram_plain(x, xt, inv_ls, sv)
    err_c = (got_c - want_c).abs()
    check(bool((err_c <= 1e-5 + 1e-4 * want_c.abs()).all()),
          f"K1 cross-gram {n}x1000: max abs err {err_c.max().item():.3e}")
    check(bool((got.diagonal(dim1=1, dim2=2) == (sv + da)[:, None]).all()),
          "K1 diag == sv + diag_add exactly")

    def library_gram(x, x2, inv_ls, sv, da=None):
        """The same Gram by `torch.cdist` (plus the nugget on a square one)."""
        xs, x2s = x[None] * inv_ls[:, None, :], x2[None] * inv_ls[:, None, :]
        K = sv[:, None, None] * torch.exp(-0.5 * torch.cdist(xs, x2s) ** 2)
        return K if da is None else K + da[:, None, None] * torch.eye(len(x), device=device)

    # device time: a call's enqueue (autograd Function, checks, ctypes)
    # outlasts this kernel, so CUDA events over back-to-back calls would
    # time the host
    ms = device_ms(torch, lambda: G.gram(x, x, inv_ls, sv, diag_add=da))
    call_ms = timed(lambda: G.gram(x, x, inv_ls, sv, diag_add=da), torch)
    cross_ms = device_ms(torch, lambda: G.gram(x, xt, inv_ls, sv))
    cross_plain_ms = device_ms(torch, lambda: G.gram_plain(x, xt, inv_ls, sv))
    cross_lib_ms = device_ms(torch, lambda: library_gram(x, xt, inv_ls, sv))
    plain_ms = device_ms(torch, lambda: G.gram_plain(x, x, inv_ls, sv, da))
    lib_ms = device_ms(torch, lambda: library_gram(x, x, inv_ls, sv, da))
    b_ms, b_by = bound(R * n * n * (3 * d + 3), 4 * (2 * n * d + R * (d + 2) + R * n * n))
    bc_ms, _ = bound(R * n * 1000 * (3 * d + 2), 4 * ((n + 1000) * d + 2 * R + R * n * 1000))
    report["gram"] = dict(
        name="gram", source="fidelityfusion_tpu_torch/csrc/gram.cu",
        replaces="benchmarks/retired/pallas_gram.py:85", max_abs_err=err.max().item(),
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        shape=f"R={R} n={n} d={d}", timing="device time, CUDA graph of 20 calls",
        call_ms=call_ms, cross_ms=cross_ms, cross_bound_ms=bc_ms, cross_plain_ms=cross_plain_ms,
        cross_library_ms=cross_lib_ms, cross_max_abs_err=err_c.max().item())
    print(f"K1 R={R} n={n} d={d}: kernel {ms * 1e3:.3f} us by device time (CUDA graph of 20 "
          f"calls; {call_ms * 1e3:.3f} us a call by events over back-to-back calls)  plain "
          f"{plain_ms:.4f} ms  cdist {lib_ms:.4f} ms  bound {b_ms * 1e3:.3f} us ({b_by}); "
          f"cross-Gram {n}x1000 {cross_ms * 1e3:.3f} us (bound {bc_ms * 1e3:.3f} us, plain "
          f"{cross_plain_ms * 1e3:.3f} us, cdist {cross_lib_ms * 1e3:.3f} us)", flush=True)
    report["gram"]["d2"] = gram_d2_checks(torch, device, gen, library_gram)
    report["gram"]["d4"] = gram_d4_checks(torch, device, gen, library_gram)
    # the Kronecker and BO shapes draw from their own generators, so the
    # checks after them keep their inputs
    report["gram"]["f64"] = gram_f64_checks(torch, device, torch.Generator().manual_seed(1),
                                            library_gram)
    report["gram"]["bo"] = gram_bo_checks(torch, device, torch.Generator().manual_seed(2),
                                          library_gram)
    report["gram"]["d10"] = gram_wide_checks(torch, device, torch.Generator().manual_seed(3),
                                             library_gram)
    report["gram"]["slab"] = gram_slab_checks(torch, device, library_gram)

    def chol_case(key, R, n, batched):
        # one panel (the BO loop's shape) from its own generator, so the
        # other shapes keep their inputs
        g = torch.Generator().manual_seed(64 + R) if n == 64 else gen
        x, inv_ls, sv, da = se_problem(torch, R, n, 1, g, device)
        A = G.gram_plain(x, x, inv_ls, sv, da)
        A = A if batched else A[0]
        # smooth targets, as the toy data (pure-noise targets load the
        # Gram's smallest eigenvalues and amplify f32 rounding differences)
        y = torch.sin(2.0 * x) + 0.05 * torch.randn((n, 1), generator=g).to(device)
        L, Wd = chol_inv(A)
        Lp, Wdp = chol_inv_plain(A.reshape(-1, n, n))
        Lp = Lp.reshape(A.shape)
        rel = ((L - Lp).norm(dim=(-2, -1)) / Lp.norm(dim=(-2, -1))).max().item()
        check(rel <= 1e-4, f"{key} chol R={R} n={n}: rel Frobenius err on L {rel:.3e} (<= 1e-4)")
        W = tri_inv(L, Wd)
        Wp = tri_inv_plain(Lp.reshape(-1, n, n), Wdp).reshape(A.shape)
        res = (W @ L - torch.eye(n, device=device)).abs().max().item()
        check(res <= 1e-3, f"K3b tri_inv R={R} n={n}: max |W L - I| {res:.3e} (<= 1e-3)")
        # the plain K3b on the kernels' own L and Wd
        Wk = tri_inv_plain(L.reshape(-1, n, n), Wd.reshape(-1, n // 64, 64, 64)).reshape(A.shape)
        err_w = (W - Wk).abs()
        check(bool((err_w <= 1e-3 + 1e-3 * Wk.abs()).all()),
              f"K3b tri_inv R={R} n={n}: W vs plain on the same L, Wd: max abs err "
              f"{err_w.max().item():.3e} (rtol, atol 1e-3)")
        v_k, v_p = nll_of(torch, L, W, y), nll_of(torch, Lp, Wp, y)
        nrel = ((v_k - v_p).abs() / v_p.abs()).max().item()
        # one batch's NLML lies at float32's rounding floor from the plain
        # version's (up to ~1.1e-5 relative over data seeds); the NLML is
        # held against float64 over 64 Grams instead (`nll_floor_check`;
        # `panel_checks` at one panel)
        print(f"{key} NLML R={R} n={n}: rel err {nrel:.3e} vs plain fp32", flush=True)
        if n > 64:
            nll_floor_check(torch, device, key, R, n)
        return A, L, Wd, (L - Lp).abs().max().item(), err_w.max().item()

    def tri_inv_timing(L, Wd, abs_err, R, n):
        # device time: at n <= 512 a call's enqueue outlasts the kernel
        eye = torch.eye(n, device=device).expand(L.shape)
        ms = device_ms(torch, lambda: tri_inv(L, Wd))
        plain_ms = device_ms(torch, lambda: tri_inv_plain(
            L.reshape(-1, n, n), Wd.reshape(-1, n // 64, 64, 64)), calls=3, reps=2)
        lib_ms = device_ms(torch, lambda: torch.linalg.solve_triangular(L, eye, upper=False))
        # bytes: L's strictly lower tiles read (its diagonal blocks come
        # from Wd), Wd read, all of W written
        b_ms, b_by = bound(R * n ** 3 / 3, 4 * R * (n * (n - 64) // 2 + n * n + n * 64))
        print(f"K3b R={R} n={n}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"solve_triangular {lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}), all by device "
              f"time (CUDA graphs)", flush=True)
        return dict(shape=f"R={R} n={n}", ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib_ms, max_abs_err=abs_err)

    def chol_timing(key, A, R, n):
        # one 64-row panel's factorization is shorter than its enqueue:
        # device time there
        run = lambda: chol_inv(A)  # noqa: E731
        ms = device_ms(torch, run) if n == 64 else timed(run, torch)
        plain_ms = timed(lambda: chol_inv_plain(A.reshape(-1, n, n)), torch, max_iters=3)
        lib_ms = timed(lambda: torch.linalg.cholesky(A), torch)
        # bytes: A's lower tiles read (diagonal included), all of L and Wd written
        b_ms, b_by = bound(R * n ** 3 / 3, 4 * R * (n * (n + 64) // 2 + n * n + n * 64))
        print(f"{key} R={R} n={n}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"torch.linalg.cholesky {lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})", flush=True)
        return dict(shape=f"R={R} n={n}", ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib_ms,
                    timing="device time" if n == 64 else "CUDA events")

    # ---- K2 (one matrix) and K3a (a restart batch): checked and timed at
    # each shape, reported at the largest; K3b checked on every factor and
    # timed at the K3a shapes and n = 1792 and 2048, reported at (4, 1024)
    leaf = leaf_us(torch, device)
    print(f"K2/K3a leaf alone: {leaf:.3f} us", flush=True)
    tri_rows = {}
    for key, name, replaces, shapes in (
            ("K2", "chol", "benchmarks/retired/pallas_cholesky.py:213",
             ((1, 64), (1, 1024), (1, 1792), (1, 2048))),
            ("K3a", "chol_batched", "benchmarks/retired/pallas_batched.py:175",
             ((4, 64), (4, 256), (4, 512), (4, 2048), (2, 1024), (4, 1024)))):
        # n = 64: one panel, as the BO loop's stages (`panel_checks`)
        rows = []
        for R, n in shapes:
            A, L, Wd, abs_err, w_err = chol_case(key, R, n, batched=key == "K3a")
            rows.append(dict(chol_timing(key, A, R, n), max_abs_err=abs_err))
            if key == "K3a" or n >= 1792 or n in (64, 1024):
                tri_rows[(R, n)] = tri_inv_timing(L, Wd, w_err, R, n)
        report[name] = dict(rows[-1], name=name, source="fidelityfusion_tpu_torch/csrc/chol.cu",
                            replaces=replaces, shapes=rows, leaf_us=leaf)
    report["tri_inv"] = dict(
        tri_rows[(4, 1024)], name="tri_inv", source="fidelityfusion_tpu_torch/csrc/tri_inv.cu",
        replaces="benchmarks/retired/pallas_batched.py:190",
        shapes=[tri_rows[k] for k in sorted(tri_rows, key=lambda k: (k[1], k[0]))])


def count_device_ops(torch, device, report):
    """Device kernels and copies of one K2 call at n = 2048, one K3a call
    at (4, 1024) and one K3b call at each, under `torch.profiler`.  Run
    last: tracing, once started, slows every later launch on the host."""
    from fidelityfusion_tpu_torch.ops.chol import chol_inv, tri_inv

    gen = torch.Generator().manual_seed(7)
    for key, name, R, n in (("K2", "chol", 1, 2048), ("K3a", "chol_batched", 4, 1024)):
        A = se_gram(torch, R, n, gen, device)
        A = A[0] if R == 1 else A
        ops = device_ops_per_call(torch, lambda: chol_inv(A))
        print(f"{key} R={R} n={n}: {ops} device kernel(s) and copies per call "
              f"(3 n/64 - 2 = {3 * n // 64 - 2} kernels before the cooperative design)", flush=True)
        check(ops == 1, f"{key}: one device kernel per factorization ({ops})")
        report[name]["device_ops_per_call"] = ops
        L, Wd = chol_inv(A)
        ops = device_ops_per_call(torch, lambda: tri_inv(L, Wd))
        print(f"K3b R={R} n={n}: {ops} device kernel(s) and copies per call "
              f"(n/64 = {n // 64} launches before the cooperative design)", flush=True)
        check(ops == 1, f"K3b R={R} n={n}: one device kernel per inverse ({ops})")
        report["tri_inv"].setdefault("device_ops_per_call", {})[f"R={R} n={n}"] = ops


def ill_conditioned_checks(torch, device):
    """K2 and K3a (with K3b) on 8 SE Grams at relative nugget 1e-6 on 1024
    evenly spaced points, length scales about 1.8 spacings: ill-conditioned,
    yet still positive definite once rounded to float32.  Their error against
    the plain version in float64 must stay within twice the plain float32
    version's, on L (Frobenius, over the batch) and on the NLML (summed
    over the batch: one matrix's NLML error is too noisy to compare)."""
    from fidelityfusion_tpu_torch.ops.chol import chol_inv, chol_inv_plain, tri_inv, tri_inv_plain
    from fidelityfusion_tpu_torch.ops.gram import gram_plain

    R, n = 8, 1024
    x = torch.linspace(-3.0, 3.0, n, device=device)[:, None]
    ls = 1.8 * 6.0 / (n - 1) * torch.linspace(0.9, 1.1, R, device=device)
    sv = torch.linspace(0.5, 2.0, R, device=device)
    A = gram_plain(x, x, (1.0 / ls)[:, None].contiguous(), sv, 1e-6 * sv)
    gen = torch.Generator().manual_seed(5)
    y = torch.sin(2.0 * x) + 0.05 * torch.randn((n, 1), generator=gen).to(device)

    def factor_plain(M):
        L, Wd = chol_inv_plain(M)
        return L, tri_inv_plain(L, Wd)

    L64, W64 = factor_plain(A.double())
    v64 = nll_of(torch, L64, W64, y.double())
    L32, W32 = factor_plain(A)
    err_L32 = (L32.double() - L64).norm().item()
    err_v32 = (nll_of(torch, L32, W32, y).double() - v64).abs().sum().item()
    for key, factor in (
            ("K3a", lambda: chol_inv(A)),
            ("K2", lambda: tuple(torch.stack(t) for t in zip(*(chol_inv(a) for a in A))))):
        L, Wd = factor()
        W = tri_inv(L, Wd)
        err_L = (L.double() - L64).norm().item()
        err_v = (nll_of(torch, L, W, y).double() - v64).abs().sum().item()
        print(f"{key} ill-conditioned R={R} n={n}: |L - L64|_F kernel {err_L:.4e} plain fp32 "
              f"{err_L32:.4e}; sum |NLML - NLML64| kernel {err_v:.4e} plain fp32 {err_v32:.4e} "
              f"(sum |NLML64| {v64.abs().sum().item():.4e})", flush=True)
        check(err_L <= 2 * err_L32 and err_v <= 2 * err_v32,
              f"{key} ill-conditioned: kernel's error vs fp64 within 2x the plain fp32 "
              f"version's (L {err_L / err_L32:.3f}x, NLML {err_v / err_v32:.3f}x)")


def panel_checks(torch, device, report, seed=7):
    """K2 and K3a (with K3b) at one 64-row panel, the BO loop's stage
    factorizations, on two inputs of 64 SE Grams each: full 64-row Grams,
    and 32-row Grams identity-padded to 64 as `ops/blocked.py:
    chol_inv_padded` gives the kernels a short stage's (the NLML is then the
    live block's).  K3a takes them 4 at a time (the restart batch), K2 one
    at a time.  As in `ill_conditioned_checks`, the kernels' error against
    the plain version in float64 must stay within twice the plain float32
    version's, on L (Frobenius, over the batch) and on the NLML (summed
    over the batch): the bar is float32's rounding at this shape, not a
    fixed number.  64 matrices: over 4 or 8, a sum of float32 errors
    varies by several times between inputs, and the ratio with it."""
    from fidelityfusion_tpu_torch.ops.blocked import _pad_identity
    from fidelityfusion_tpu_torch.ops.chol import chol_inv, chol_inv_plain, tri_inv, tri_inv_plain
    from fidelityfusion_tpu_torch.ops.gram import gram_plain

    gen = torch.Generator().manual_seed(seed)
    report["panel64"] = {}
    for live in (64, 32):
        x, inv_ls, sv, da = se_problem(torch, 64, live, 1, gen, device)
        A = _pad_identity(gram_plain(x, x, inv_ls, sv, da), 64)
        y = torch.sin(2.0 * x) + 0.05 * torch.randn((live, 1), generator=gen).to(device)
        crop = lambda M: M[..., :live, :live]  # noqa: E731  (inv(L) of a padded L is padded)

        def factor_plain(M):
            L, Wd = chol_inv_plain(M)
            return L, tri_inv_plain(L, Wd)

        def errors(L, W):
            return ((crop(L).double() - crop(L64)).norm().item(),
                    (nll_of(torch, crop(L), crop(W), y).double() - v64).abs().sum().item())

        L64, W64 = factor_plain(A.double())
        v64 = nll_of(torch, crop(L64), crop(W64), y.double())
        err_L32, err_v32 = errors(*factor_plain(A))
        out = {"plain fp32": (err_L32, err_v32), "sum |NLML64|": v64.abs().sum().item()}
        for key, factor in (
                ("K3a", lambda: tuple(torch.cat(t) for t in zip(
                    *(chol_inv(A[i:i + 4]) for i in range(0, len(A), 4))))),
                ("K2", lambda: tuple(torch.stack(t) for t in zip(*(chol_inv(a) for a in A))))):
            L, Wd = factor()
            err_L, err_v = errors(L, tri_inv(L, Wd))
            out[key] = (err_L, err_v)
            print(f"{key} one panel, {live} live rows, 64 Grams: |L - L64|_F kernel {err_L:.4e} "
                  f"plain fp32 {err_L32:.4e}; sum |NLML - NLML64| kernel {err_v:.4e} plain fp32 "
                  f"{err_v32:.4e} (sum |NLML64| {out['sum |NLML64|']:.4e})", flush=True)
            check(err_L <= 2 * err_L32 and err_v <= 2 * err_v32,
                  f"{key} n=64 ({live} live rows): kernel's error vs fp64 within 2x the plain "
                  f"fp32 version's (L {err_L / err_L32:.3f}x, NLML {err_v / err_v32:.3f}x)")
        report["panel64"][f"{live} live rows"] = out


def nan_pivot_check(torch, device):
    """A negative pivot in panel 2 of matrix 1 of a K3a batch, and alone
    through K2: NaN from there on in that factor, its inverse (K3b) and its
    NLML; the other matrices' factors and inverses as the plain versions
    have them, and the launches return."""
    from fidelityfusion_tpu_torch.ops.chol import chol_inv, chol_inv_plain, tri_inv, tri_inv_plain

    A = se_gram(torch, 3, 512, torch.Generator().manual_seed(6), device)
    A[1, 150, 150] = -1.0
    y = torch.ones((512, 1), device=device)
    L, Wd = chol_inv(A)
    W = tri_inv(L, Wd)
    v = nll_of(torch, L, W, y)
    L2, _ = chol_inv(A[1])
    torch.cuda.synchronize()
    Lp, Wdp = chol_inv_plain(A[[0, 2]])
    rel = ((L[[0, 2]] - Lp).norm(dim=(1, 2)) / Lp.norm(dim=(1, 2))).max().item()
    Wp = tri_inv_plain(L[[0, 2]], Wd[[0, 2]])
    rel_w = ((W[[0, 2]] - Wp).norm(dim=(1, 2)) / Wp.norm(dim=(1, 2))).max().item()
    ok = (bool(torch.isnan(L[1, 150:, 150]).all()) and bool(torch.isnan(v[1]))
          and bool(torch.isnan(W[1, 150:, 150]).all())
          and bool(torch.isfinite(L[1, :128]).all()) and bool(torch.isfinite(v[[0, 2]]).all())
          and bool(torch.isfinite(W[[0, 2]]).all())
          and bool(torch.isnan(L2[150:, 150]).all()) and rel <= 1e-4 and rel_w <= 1e-4)
    check(ok, f"negative pivot: NaN in that factor, its inverse and its NLML (K3a, K3b and "
              f"K2), the others finite and within {rel:.2e} (L), {rel_w:.2e} (W) of plain")


def plain_sigma(torch, gp, params, x, y_var=None):
    """A CIGP's or GPBasic's Sigma (no mask) through the plain version of
    K1 only: an SE-form kernel's Gram with its nugget in one pass, as the
    models build it; CAR-large's kernel as the plain base Gram times its
    feature product, the nugget added after."""
    from fidelityfusion_tpu_torch.ops.gram import gram_plain
    from fidelityfusion_tpu_torch.ops.linalg import assemble_sigma

    kernel, kp = gp.kernel, params["kernel"]
    if kernel.SE_FORM:
        inv_ls, sv = kernel.gram_args(kp, x.shape[1])
        jit = gp.jitter * sv if gp.relative_jitter else gp.jitter
        return gram_plain(x, x, inv_ls.reshape(1, -1), sv.reshape(1),
                          (gp.noise(params, sv) + jit).reshape(1),
                          None if y_var is None else y_var.reshape(1, -1))[0]
    f = kernel.features(kp, x[:, -1])
    inv_ls, base_sv = kernel.base.gram_args(kp["base"], x.shape[1] - 1)
    K = (kp["signal_variance"].abs()[0] * (f @ f.T) * gram_plain(
        x[:, :-1], x[:, :-1], inv_ls.reshape(1, -1), base_sv.reshape(1))[0])
    return assemble_sigma(K, gp.noise(params, K.diagonal().mean()), gp.jitter, y_var=y_var,
                          relative_jitter=gp.relative_jitter)


def plain_nll(torch, Sigma, y) -> float:
    """NLML of y ~ N(0, Sigma) through the plain versions of K2 and K3b,
    in Sigma's dtype (identity-padded to the panel, as the kernels are)."""
    from fidelityfusion_tpu_torch.ops.chol import PANEL, chol_inv_plain, tri_inv_plain
    from fidelityfusion_tpu_torch.ops.linalg import LOG2PI

    n = Sigma.shape[-1]
    n_pad = -(-n // PANEL) * PANEL
    Sp = torch.eye(n_pad, dtype=Sigma.dtype, device=Sigma.device)[None].clone()
    Sp[:, :n, :n] = Sigma
    L, Wd = chol_inv_plain(Sp)
    W = tri_inv_plain(L, Wd)[0, :n, :n]
    y = y.reshape(n, -1)
    gamma = W @ y
    return float(0.5 * (gamma * gamma).sum() + y.shape[1] * torch.log(
        L[0].diagonal()[:n]).sum() + 0.5 * n * y.shape[1] * LOG2PI)


def plain_stage_nll(torch, gp, params, x, y, dtype, y_var=None):
    """A stage's NLML through the plain versions of K1, K2 and K3b only,
    in ``dtype``."""
    from fidelityfusion_tpu_torch.utils.tree import tree_map

    params = tree_map(lambda a: a.to(dtype), params)
    x, y = x.to(dtype), y.to(dtype)
    y_var = None if y_var is None else y_var.to(dtype)
    return plain_nll(torch, plain_sigma(torch, gp, params, x, y_var), y)


def check_stage_nll(torch, label, nll_card, v_plain, v_plain64, trained, rows):
    """The NLML through the kernels (``nll_card``) and the training's final
    score (``trained``, or None) against the plain versions' in float32,
    within 1e-3 of max(|NLML|, rows)."""
    # fp32 at the trained optimum: the nugget sits near its floor, so
    # cond(Sigma) ~ 1e6-1e7 and two fp32 factorizations differ by ~1e-4
    # of the NLML's O(rows) terms, whatever their order.  Scale:
    # max(|NLML|, rows); the float64 plain value shows which is closer.
    scale = max(abs(v_plain), float(rows))
    rel = abs(nll_card - v_plain) / scale
    rel_train = 0.0 if trained is None else abs(trained - v_plain) / scale
    print(f"{label}: NLML kernels {nll_card:.6f}  training "
          f"{'-' if trained is None else f'{trained:.6f}'}  plain fp32 {v_plain:.6f}  plain fp64 "
          f"{v_plain64:.6f}  |kernels - fp64| {abs(nll_card - v_plain64):.3e}  |plain fp32 - "
          f"fp64| {abs(v_plain - v_plain64):.3e}", flush=True)
    check(rel <= 1e-3 and rel_train <= 1e-3,
          f"{label} NLML kernels vs plain: rel {rel:.2e}, training vs plain {rel_train:.2e} "
          f"(<= 1e-3 of max(|nll|, rows))")


def main_path_setup(device):
    """(model, data manager, x_test, y_test) of the main path: the toy sin
    on nested `SIZES`-row subsets of 2048 points, an untrained AR over SE
    CIGPs on ``device``."""
    from fidelityfusion_tpu_torch.demo import _toy_3fid
    from fidelityfusion_tpu_torch.models.ar import AR
    from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager
    from fidelityfusion_tpu_torch.ops.kernels import SquaredExponentialKernel

    xs, ys, x_test, y_test = _toy_3fid(seed=1, sizes=SIZES, pool=2048, n_test=1000, nested=True)
    dm = MultiFidelityDataManager([
        {"raw_fidelity_name": str(i), "fidelity_indicator": i, "X": x, "Y": y}
        for i, (x, y) in enumerate(zip(xs, ys))])
    model = AR(3, [SquaredExponentialKernel() for _ in range(3)], input_dim=1, device=device)
    return model, dm, x_test, y_test


class StageClock:
    """A cascade trainer's debugger: host seconds of each stage,
    synchronized, and (given the model) a copy of its parameters as each
    stage ends (staged CAR's global b moves on in later stages)."""

    def __init__(self, torch, model=None):
        self.torch = torch
        self.model = model
        self.t = time.perf_counter()
        self.seconds = []
        self.params = []

    def record_stage(self, i, hist):
        self.torch.cuda.synchronize()
        now = time.perf_counter()
        self.seconds.append(now - self.t)
        if self.model is not None:
            from fidelityfusion_tpu_torch.utils.tree import tree_map

            self.params.append(tree_map(lambda a: a.clone(), self.model.params))
        self.t = now


def main_path(torch, device, iters, report):
    import numpy as np

    from fidelityfusion_tpu_torch.models.ar import train_AR
    from fidelityfusion_tpu_torch.ops import cuda
    from fidelityfusion_tpu_torch.train.fit import restart_scores

    model, dm, x_test, y_test = main_path_setup(device)
    cuda.reset_launch_counts()
    clock = StageClock(torch)
    hists = train_AR(model, dm, max_iter=iters, lr_init=5e-2, n_restarts=4, debugger=clock)
    mean, cov = model.forward(dm, x_test)
    post, state = model.export_posterior(dm)
    pm, pv = post(state, x_test)
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    report["main_counts"] = counts
    report["stage_seconds"] = clock.seconds

    mean_np = mean.cpu().numpy()
    rmse = float(np.sqrt(np.mean((mean_np - y_test) ** 2)))
    for i, h in enumerate(hists):
        score = restart_scores(h)
        best = int(np.argmin(score))
        print(f"stage {i}: rows {SIZES[i]}  final NLML {score[best]:.6f}  "
              f"chosen restart {best}  restart scores {np.round(score, 4).tolist()}  "
              f"wall {clock.seconds[i]:.3f} s", flush=True)
        check(bool(np.isfinite(score[best])), f"stage {i} final NLML finite")
        report.setdefault("main_stage_nll", []).append(float(score[best]))
        # the winner's NLML, re-evaluated through the plain versions on the card
        gp, p = model.gp_list[i], model.params["gp"][i]
        if i == 0:
            x_tr, y_tr = dm.get_data(0, normal=True)
        else:
            x_tr, y_tr = dm.get_data_by_name(f"res-{i}")
            y_tr = y_tr[0]
        xt = torch.as_tensor(np.asarray(x_tr, np.float32), device=device)
        yt = torch.as_tensor(np.asarray(y_tr, np.float32), device=device)
        with torch.no_grad():
            v_card = float(gp.nll(p, xt, yt))
        check_stage_nll(torch, f"stage {i}", v_card,
                        plain_stage_nll(torch, gp, p, xt, yt, torch.float32),
                        plain_stage_nll(torch, gp, p, xt, yt, torch.float64),
                        float(score[best]), xt.shape[0])
    print(f"main path: test RMSE vs sin(x) {rmse:.5f}  wall {sum(clock.seconds):.3f} s "
          f"(train)  launches {counts}", flush=True)
    check(bool(np.isfinite(mean_np).all()) and mean_np.shape == (1000, 1)
          and cov.shape == (1000, 1000), "forward: finite mean (1000, 1), cov (1000, 1000)")
    check(rmse < 0.1, f"test RMSE {rmse:.5f} < 0.1")
    dif = (pm - mean).abs().max().item()
    vdif = (pv - cov.diagonal()).abs().max().item()
    check(dif < 1e-3 and vdif < 1e-3,
          f"export_posterior matches forward: max |dmean| {dif:.2e}, |dvar| {vdif:.2e}")
    for name in ("gram", "chol", "chol_batched", "tri_inv"):
        check(counts.get(name, 0) > 0, f"main path launched {name} ({counts.get(name, 0)} times)")


def _stage_data(torch, dm, name, i, device):
    """(x, y, y_var) of stage i of a trained cascade, on the card."""
    import numpy as np

    if i == 0:
        x, y = dm.get_data(0, normal=True)
        y_var = None
    else:
        x, (y, y_var) = dm.get_data_by_name(f"{'concat' if name == 'NAR' else 'res'}-{i}")
    t = lambda a: None if a is None else torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float32), device=device)
    return t(x), t(y), t(y_var)


def cascade_launches(name, required, counts):
    for key in required:
        check(counts.get(key, 0) > 0, f"{name} launched {key} ({counts.get(key, 0)} times)")


def staged_cascade(torch, device, name, iters, report):
    """Train one staged cascade (ResGP, NAR or staged CAR) as the main path
    trains AR, hold each stage's NLML against the plain versions, predict
    the 1000 test points; returns the test RMSE."""
    import numpy as np

    from fidelityfusion_tpu_torch.models import car, nar, resgp
    from fidelityfusion_tpu_torch.ops import cuda
    from fidelityfusion_tpu_torch.ops.kernels import ARDKernel, SquaredExponentialKernel
    from fidelityfusion_tpu_torch.train.fit import restart_scores

    _, dm, x_test, y_test = main_path_setup(device)
    if name == "CAR":
        model = car.ContinuousAutoRegression(3, [ARDKernel() for _ in range(3)], device=device)
        train = car.train_CAR
    else:
        cls, train = {"ResGP": (resgp.ResGP, resgp.train_ResGP),
                      "NAR": (nar.NAR, nar.train_NAR)}[name]
        model = cls(3, [SquaredExponentialKernel() for _ in range(3)], device=device)
    cuda.reset_launch_counts()
    clock = StageClock(torch, model)
    hists = train(model, dm, max_iter=iters, lr_init=5e-2, n_restarts=4, debugger=clock)
    mean, cov = model.forward(dm, x_test)
    if name != "CAR":
        post, state = model.export_posterior(dm)
        pm, pv = post(state, x_test)
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    report["launches_by_path"][name] = counts
    report["cascades"][name] = {"stage_seconds": clock.seconds,
                                "ms_per_step": [t / iters * 1e3 for t in clock.seconds]}
    for i, h in enumerate(hists):
        score = restart_scores(h)
        best = int(np.argmin(score))
        print(f"{name} stage {i}: rows {SIZES[i]}  final NLML {score[best]:.6f}  chosen restart "
              f"{best}  restart scores {np.round(score, 4).tolist()}  wall "
              f"{clock.seconds[i]:.3f} s ({clock.seconds[i] / iters * 1e3:.2f} ms/step)",
              flush=True)
        check(bool(np.isfinite(score[best])), f"{name} stage {i} final NLML finite")
        gp, p = model.gp_list[i], clock.params[i]["gp"][i]
        if name == "CAR" and i > 0:
            p = car._bind_b(p, clock.params[i]["b"])
        x, y, y_var = _stage_data(torch, dm, name, i, device)
        with torch.no_grad():
            v_card = float(gp.nll(p, x, y, y_var=y_var))
        check_stage_nll(torch, f"{name} stage {i}", v_card,
                        plain_stage_nll(torch, gp, p, x, y, torch.float32, y_var),
                        plain_stage_nll(torch, gp, p, x, y, torch.float64, y_var),
                        float(score[best]), x.shape[0])
    mean_np = mean.cpu().numpy()
    rmse = float(np.sqrt(np.mean((mean_np - y_test) ** 2)))
    bar = 0.25 if name == "CAR" else 0.1
    print(f"{name}: test RMSE vs sin(x) {rmse:.5f}  wall {sum(clock.seconds):.3f} s (train)  "
          f"launches {counts}", flush=True)
    check(bool(np.isfinite(mean_np).all()) and mean_np.shape == (1000, 1)
          and cov.shape == (1000, 1000), f"{name} forward: finite mean (1000, 1), cov (1000, 1000)")
    check(rmse < bar, f"{name} test RMSE {rmse:.5f} < {bar}")
    if name != "CAR":
        dif = (pm - mean).abs().max().item()
        vdif = (pv - cov.diagonal()).abs().max().item()
        check(dif < 1e-3 and vdif < 1e-3, f"{name} export_posterior matches forward: max |dmean| "
                                          f"{dif:.2e}, |dvar| {vdif:.2e}")
    cascade_launches(name, ("gram", "chol", "chol_batched", "tri_inv"), counts)
    return rmse


def fit_path(torch, name, fit_fn, nll_fn, plain_fn, rows, report):
    """An unbatched fit of ``FIT_STEPS`` steps: ``fit_fn()`` returns the loss
    history; afterwards ``nll_fn()`` (the kernels) and ``plain_fn(dtype)``
    (the plain versions) give the final NLML.  Checks finite, falling
    losses and the final NLML against the plain versions."""
    from fidelityfusion_tpu_torch.ops import cuda

    cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    losses = fit_fn().cpu()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    counts = cuda.launch_counts()
    report["launches_by_path"][name] = counts
    report["cascades"][name] = {"seconds": sec, "ms_per_step": sec / FIT_STEPS * 1e3}
    print(f"{name}: {FIT_STEPS} unbatched steps over {rows} rows: NLML {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, wall {sec:.3f} s ({sec / FIT_STEPS * 1e3:.2f} ms/step), launches "
          f"{counts}", flush=True)
    check(bool(torch.isfinite(losses).all()) and losses[-1] < losses[0],
          f"{name}: losses finite and falling")
    with torch.no_grad():
        check_stage_nll(torch, name, float(nll_fn()), plain_fn(torch.float32),
                        plain_fn(torch.float64), None, rows)
    cascade_launches(name, ("gram", "chol", "tri_inv"), counts)


def car_large_path(torch, device, report):
    """CAR-large: a `FIT_STEPS`-step joint fit over all the fidelities' rows
    (1024 + 512 + 256), then `forward`; RMSE < 0.4 (the JAX test's bar)."""
    import numpy as np

    from fidelityfusion_tpu_torch.models import car
    from fidelityfusion_tpu_torch.ops.kernels import ARDKernel
    from fidelityfusion_tpu_torch.utils.tree import tree_map

    _, dm, x_test, y_test = main_path_setup(device)
    model = car.ContinuousAutoRegressionLarge(3, ARDKernel(), device=device)
    x, y = model.joint_train_data(dm)

    def plain(dtype):
        p = tree_map(lambda a: a.to(dtype), model.params)
        return plain_nll(torch, plain_sigma(torch, model.gp, p, x.to(dtype)), y.to(dtype))

    fit_path(torch, "CAR-large",
             lambda: car.train_CAR_large(model, dm, max_iter=FIT_STEPS, lr_init=5e-2),
             lambda: model.gp.nll(model.params, x, y), plain, x.shape[0], report)
    with torch.no_grad():
        mean, cov = model.forward(dm, x_test)
    mean_np = mean.cpu().numpy()
    rmse = float(np.sqrt(np.mean((mean_np - y_test) ** 2)))
    print(f"CAR-large: test RMSE vs sin(x) {rmse:.5f}", flush=True)
    check(bool(np.isfinite(mean_np).all()) and cov.shape == (1000, 1000),
          "CAR-large forward: finite mean, cov (1000, 1000)")
    check(rmse < 0.4, f"CAR-large test RMSE {rmse:.5f} < 0.4")
    return rmse


def fides_path(torch, device, report):
    """FIDES at bounds (0, 1, 0, 1): a `FIT_STEPS`-step fit to 1024 rows of
    the toy's top fidelity (sin(x) + noise), standardized as the demo does,
    then `predict` at 1000 test points; RMSE < 0.2 (the JAX test's bar),
    variances > 0."""
    import numpy as np

    from fidelityfusion_tpu_torch.demo import _toy_3fid
    from fidelityfusion_tpu_torch.models.fides import FIDES, FidelityBounds
    from fidelityfusion_tpu_torch.ops.gram import gram_plain
    from fidelityfusion_tpu_torch.train.fit import fit
    from fidelityfusion_tpu_torch.utils.tree import tree_map

    xs, ys, x_test, y_test = _toy_3fid(seed=1, sizes=(1024,) * 3, pool=2048, n_test=1000,
                                       nested=True)
    xm, xsd, ym, ysd = xs[2].mean(), xs[2].std(), ys[2].mean(), ys[2].std()
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    x, y, xt = t((xs[2] - xm) / xsd), t((ys[2] - ym) / ysd), t((x_test - xm) / xsd)
    fides, bounds = FIDES(), FidelityBounds(0.0, 1.0, 0.0, 1.0)
    state = {"params": fides.init_params(1, device=device)}

    def run():
        res = fit(fides.nll, state["params"], steps=FIT_STEPS, lr=5e-2, loss_args=(x, y, bounds))
        state["params"] = res.params
        return res.losses

    def plain(dtype):
        p = tree_map(lambda a: a.to(dtype), state["params"])
        inv_ls, sv = fides.gram_args(p, 1, bounds)
        Sigma = gram_plain(x.to(dtype), x.to(dtype), inv_ls.reshape(1, -1), sv.reshape(1),
                           (fides.noise(p) + fides.jitter).reshape(1))[0]
        return plain_nll(torch, Sigma, y.to(dtype))

    fit_path(torch, "FIDES", run, lambda: fides.nll(state["params"], x, y, bounds), plain,
             x.shape[0], report)
    with torch.no_grad():
        mean, var = fides.predict(state["params"], x, y, xt, bounds)
    mean_np = mean.cpu().numpy() * ysd + ym
    rmse = float(np.sqrt(np.mean((mean_np - y_test) ** 2)))
    print(f"FIDES: test RMSE vs sin(x) {rmse:.5f}", flush=True)
    check(bool(np.isfinite(mean_np).all()) and bool((var > 0).all()),
          "FIDES predict: finite mean, variances > 0")
    check(rmse < 0.2, f"FIDES test RMSE {rmse:.5f} < 0.2")
    return rmse


def cascade_paths(torch, device, iters, report):
    """Phase 4: the slice's other cascades, each with its own launch counts."""
    report.setdefault("launches_by_path", {})["AR"] = report["main_counts"]
    report["cascades"] = {}
    rmse = {name: staged_cascade(torch, device, name, iters, report)
            for name in ("ResGP", "NAR", "CAR")}
    rmse["CAR-large"] = car_large_path(torch, device, report)
    rmse["FIDES"] = fides_path(torch, device, report)
    report["cascade_rmse"] = rmse


def plain_kron_nll(torch, hogp, params, x, y, y_var=None, dtype=None) -> float:
    """A HOGP's exact NLML through the plain version of K1 and
    `torch.linalg.eigh`, in ``dtype`` (float64: the reference for the
    kernels' float32)."""
    from fidelityfusion_tpu_torch.ops import kron
    from fidelityfusion_tpu_torch.ops.gram import gram_plain
    from fidelityfusion_tpu_torch.utils.tree import tree_map

    dtype = dtype or torch.float64
    p = tree_map(lambda a: a.to(dtype), params)
    kp = p["kernel"]

    def K(a, b, diag_add=None, yv=None):
        inv_ls, sv = hogp.kernel.gram_args(kp, a.shape[1])
        inv_ls = inv_ls.reshape(1, -1).expand(1, a.shape[1])
        return gram_plain(a.to(dtype), b.to(dtype), inv_ls, sv.reshape(1), diag_add,
                          None if yv is None else yv.to(dtype).reshape(1, -1))[0]

    jit = torch.tensor([hogp.jitter], dtype=dtype, device=x.device)
    Ks = [K(x, x, jit, y_var)] + [K(g, g) for g in hogp.grids(p)]
    Kb, yb, nb = kron._batched(Ks, y.to(dtype), hogp.noise(p))
    pairs = [kron.eigh_pairs(Km) for Km in Kb]
    loss = kron._loss_and_saved([q[0] for q in pairs], [q[1] for q in pairs], yb, nb)[0]
    return float(loss[0])


def check_kron_nll(label, v_card, v32, v64, trained=None, tol=1e-3):
    """A HOGP NLML through the kernels within ``tol`` of max(|NLML|, 1)
    (element-normalized NLMLs are O(1)) of the plain float64 one (K1's
    plain version and `torch.linalg.eigh` in float64); the plain float32
    one is printed beside it: at hogp1024 the NLML moves by ~1e-3 with K_0's
    float32 rounding alone."""
    scale = max(abs(v64), 1.0)
    rel64, rel32, plain64 = (abs(v_card - v64) / scale, abs(v_card - v32) / scale,
                             abs(v32 - v64) / scale)
    print(f"{label}: NLML kernels {v_card:.6f}  training "
          f"{'-' if trained is None else f'{trained:.6f}'}  plain fp32 {v32:.6f}  plain fp64 "
          f"{v64:.6f}  /max(|NLML|, 1): |kernels - fp64| {rel64:.3e}  |kernels - fp32| "
          f"{rel32:.3e}  |plain fp32 - fp64| {plain64:.3e}", flush=True)
    check(rel64 <= tol, f"{label}: NLML through K1 vs plain fp64 {rel64:.2e} (<= {tol:g} of "
                        f"max(|NLML|, 1))")


class ResidualProbe:
    """Wraps a HOGP spec's `nll_tracked` to keep the running max of the
    tracking residual over every restart and step (the trainer keeps it
    per restart in its aux but returns only the winner's params)."""

    def __init__(self, torch):
        self.torch = torch
        self.max_res = {}

    def wrap(self, hogp, key):
        import dataclasses

        probe = self

        @dataclasses.dataclass(frozen=True)
        class Probed(type(hogp)):
            def nll_tracked(self, *args, **kwargs):
                loss, aux = super().nll_tracked(*args, **kwargs)
                prev = probe.max_res.get(key)
                cur = aux[1].detach().max()
                probe.max_res[key] = cur if prev is None else probe.torch.maximum(prev, cur)
                return loss, aux

        return Probed(**{f.name: getattr(hogp, f.name) for f in dataclasses.fields(hogp)})


def hogp1024_path(torch, device, report, steps=130, seed=0):
    """The JAX bench's shipping HOGP shape (`bench.py:_hogp_setup`, `:483`):
    n = 1024, output (32, 32, 32), SE kernel, inputs and targets from a
    numpy seed; `fit` through `nll_tracked(refresh_every=64)` with the
    tracking aux for ``steps`` Adam steps at lr 1e-2 (refreshes at 0, 64,
    128).  Checks max_res < 0.30, the final tracked loss within 1e-2 of the
    exact `nll` at the same params, and `nll` within 1e-3 of max(|NLML|, 1)
    of the plain float64 recomputation (`check_kron_nll`).  ``seed`` seeds
    the data."""
    import numpy as np

    from fidelityfusion_tpu_torch.models.hogp import HOGP
    from fidelityfusion_tpu_torch.ops import cuda
    from fidelityfusion_tpu_torch.ops.kernels import SquaredExponentialKernel
    from fidelityfusion_tpu_torch.train.fit import fit

    x, y, shape = _hogp1024_data(torch, device, seed)
    n = x.shape[0]
    hogp = HOGP(kernel=SquaredExponentialKernel(), output_shape=shape)
    p0 = hogp.init_params(4, device=device)
    stamps, last_aux = [], {}

    def loss(p, aux, step, x, y):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        out = hogp.nll_tracked(p, aux, step, x, y, refresh_every=64)
        last_aux["aux"] = out[1]
        return out

    cuda.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = fit(loss, p0, steps=steps, lr=1e-2, loss_args=(x, y),
              aux0=hogp.tracking_aux0(n, device=device))
    losses = res.losses.cpu()
    sec = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = cuda.launch_counts()
    step_ms = np.diff(np.asarray(stamps)) * 1e3  # step i: stamps[i] -> stamps[i + 1]
    refresh_ms = {i: float(step_ms[i]) for i in (0, 64, 128) if i < len(step_ms)}
    tracked_ms = float(np.median([step_ms[i] for i in range(1, len(step_ms)) if i % 64]))
    max_res = float(last_aux["aux"][1])
    with torch.no_grad():
        exact = float(hogp.nll(res.params, x, y))
        v32 = plain_kron_nll(torch, hogp, res.params, x, y, dtype=torch.float32)
        v64 = plain_kron_nll(torch, hogp, res.params, x, y)
    print(f"hogp1024: {steps} steps in {sec:.3f} s ({sec / steps * 1e3:.2f} ms/step overall; "
          f"median tracked step {tracked_ms:.2f} ms; refresh steps {refresh_ms} ms, step 0 "
          f"with warm-up); NLML {losses[0]:.6f} -> {losses[-1]:.6f}; max_res {max_res:.4f}; "
          f"peak memory {peak:.3f} GiB; launches {counts}", flush=True)
    print(f"peak memory hogp1024 (torch.cuda.max_memory_allocated): {peak:.3f} GiB", flush=True)
    check(bool(torch.isfinite(losses).all()) and losses[-1] < losses[0],
          "hogp1024: losses finite and falling")
    check(max_res < 0.30, f"hogp1024: max tracking residual {max_res:.4f} < 0.30")
    dv = abs(float(losses[-1]) - exact)
    check(dv <= 1e-2, f"hogp1024: final tracked loss {float(losses[-1]):.6f} vs exact nll "
                      f"{exact:.6f} at the same params: {dv:.2e} (<= 1e-2)")
    check_kron_nll("hogp1024", exact, v32, v64)
    report["launches_by_path"]["HOGP"] = counts
    report["kron"]["HOGP"] = dict(ms_per_step=sec / steps * 1e3, tracked_step_ms=tracked_ms,
                                  refresh_step_ms=refresh_ms, max_res=max_res, peak_gib=peak,
                                  final_nll=exact, plain32_nll=v32, plain64_nll=v64)


def field_setup(device, flat=False, nonsubset=False):
    """The Kronecker path's data: Poisson fields at resolutions (8, 16, 32)
    (`generate_poisson_mf_dataset`'s default), d_in = 4, from seed 0.
    Subset: 1152 samples, nested training rows `SIZES` (fidelity i on the
    first SIZES[i] samples), the last 128 the test set.  ``nonsubset``: 1536
    samples, fidelity 0 on samples 0..1023, fidelity 1 on 768..1279 and
    fidelity 2 on 1152..1407 (half of each higher fidelity's rows lie
    outside the fidelity below, so the imputation runs), the last 128 the
    test set.  (data manager, shapes, x_test, top-fidelity test fields)."""
    from fidelityfusion_tpu_torch.data.pde import generate_poisson_mf_dataset
    from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager

    n_all = 1536 if nonsubset else SIZES[0] + 128
    x, ys = generate_poisson_mf_dataset(n_samples=n_all, d_in=4, seed=0)
    shapes = [f.shape[1:] for f in ys]
    ys = [f.reshape(len(f), -1) for f in ys] if flat else ys
    starts = (0, 768, 1152) if nonsubset else (0, 0, 0)
    dm = MultiFidelityDataManager([
        {"raw_fidelity_name": str(i), "fidelity_indicator": i, "X": x[s:s + n],
         "Y": ys[i][s:s + n]} for i, (s, n) in enumerate(zip(starts, SIZES))])
    return dm, shapes, x[n_all - 128:], ys[-1][n_all - 128:]


def field_metrics(label, mean, truth, bar=0.6):
    import numpy as np

    mean = mean.cpu().numpy()
    rmse = float(np.sqrt(np.mean((mean - truth) ** 2)))
    rel = float(np.linalg.norm(mean - truth) / np.linalg.norm(truth))
    print(f"{label}: test RMSE {rmse:.6f}  relative L2 error {rel:.5f} against the top "
          f"fields", flush=True)
    check(bool(np.isfinite(mean).all()) and mean.shape == truth.shape,
          f"{label} forward: finite mean of shape {truth.shape}")
    check(rel < bar, f"{label}: relative error {rel:.5f} < {bar}")
    return rmse, rel


class LaunchClock(StageClock):
    """`StageClock` that also keeps the launch counts as each stage ends."""

    def __init__(self, torch, model=None):
        super().__init__(torch, model)
        self.counts = []

    def record_stage(self, i, hist):
        from fidelityfusion_tpu_torch.ops import cuda

        super().record_stage(i, hist)
        self.counts.append(cuda.launch_counts())


def _stage_launches(clock):
    prev, out = {}, []
    for c in clock.counts:
        out.append({k: v - prev.get(k, 0) for k, v in c.items()})
        prev = c
    return out


def gar_path(torch, device, iters, report):
    """GAR, the slice's main path: `train_GAR` over ARD HOGPs with 4
    restarts at lr 5e-2 on `field_setup`'s data (stages 0 and 1 through
    the tracked spectrum, stage 2 exact eigh every step), then `forward` on
    the 128 test samples; each stage's NLML through K1 within 1e-3 of
    max(|NLML|, 1) of the plain float64 one (`check_kron_nll`), the
    relative error < 0.6."""
    import numpy as np

    from fidelityfusion_tpu_torch.models.gar import GAR, train_GAR
    from fidelityfusion_tpu_torch.ops import cuda
    from fidelityfusion_tpu_torch.ops.kernels import ARDKernel
    from fidelityfusion_tpu_torch.train.fit import restart_scores

    dm, shapes, x_test, truth = field_setup(device)
    model = GAR(3, [ARDKernel() for _ in range(3)], shapes, input_dim=4, device=device)
    probe = ResidualProbe(torch)
    model.hogp_list = [probe.wrap(h, i) for i, h in enumerate(model.hogp_list)]
    cuda.reset_launch_counts()
    clock = LaunchClock(torch, model)
    hists = train_GAR(model, dm, max_iter=iters, lr_init=5e-2, n_restarts=4, debugger=clock)
    with torch.no_grad():
        mean, var = model.forward(dm, x_test)
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    per_stage = _stage_launches(clock)
    stages = []
    for i, h in enumerate(hists):
        score = restart_scores(h)
        best = int(np.argmin(score))
        x, y, y_var = model._stage_train_data(dm, i)
        p = clock.params[i]["hogp"][i]
        with torch.no_grad():
            v_card = float(model.hogp_list[i].nll(p, x, y, y_var))
        v32 = plain_kron_nll(torch, model.hogp_list[i], p, x, y, y_var, dtype=torch.float32)
        v64 = plain_kron_nll(torch, model.hogp_list[i], p, x, y, y_var)
        res = probe.max_res.get(i)
        res = None if res is None else float(res)
        ms = clock.seconds[i] / iters * 1e3
        print(f"GAR stage {i}: rows {SIZES[i]} output {shapes[i]}  "
              f"{'tracked' if res is not None else 'exact eigh'}  final NLML {score[best]:.6f}  "
              f"chosen restart {best}  scores {np.round(score, 5).tolist()}  wall "
              f"{clock.seconds[i]:.3f} s ({ms:.2f} ms/step)  max_res "
              f"{'-' if res is None else f'{res:.4f}'}  K1 launches "
              f"{per_stage[i].get('gram', 0)}", flush=True)
        check(bool(np.isfinite(score[best])), f"GAR stage {i} final NLML finite")
        check_kron_nll(f"GAR stage {i}", v_card, v32, v64, float(score[best]))
        stages.append(dict(rows=SIZES[i], ms_per_step=ms, seconds=clock.seconds[i], max_res=res,
                           launches=per_stage[i], final_nll=v_card, plain32_nll=v32,
                           plain64_nll=v64))
    check(probe.max_res.keys() == {0, 1}, f"GAR: stages 0 and 1 tracked, stage 2 exact "
                                          f"({sorted(probe.max_res)})")
    check(bool((var > 0).all()), "GAR forward: variances > 0")
    rmse, rel = field_metrics("GAR", mean, truth)
    cascade_launches("GAR", ("gram",), counts)
    report["launches_by_path"]["GAR"] = counts
    report["kron"]["GAR"] = dict(stages=stages, rmse=rmse, rel_err=rel)


def cigar_path(torch, device, iters, report):
    """CIGAR on the same data and settings (outputs flattened): each
    stage's NLML held against the plain versions as the cascades' are;
    K1, K2, K3a and K3b all launched."""
    import numpy as np

    from fidelityfusion_tpu_torch.models.cigar import CIGAR, train_CIGAR
    from fidelityfusion_tpu_torch.ops import cuda
    from fidelityfusion_tpu_torch.ops.kernels import ARDKernel
    from fidelityfusion_tpu_torch.train.fit import restart_scores

    dm, shapes, x_test, truth = field_setup(device, flat=True)
    model = CIGAR(3, [ARDKernel() for _ in range(3)], shapes, input_dim=4, device=device)
    cuda.reset_launch_counts()
    clock = LaunchClock(torch, model)
    hists = train_CIGAR(model, dm, max_iter=iters, lr_init=5e-2, n_restarts=4, debugger=clock)
    with torch.no_grad():
        mean, var = model.forward(dm, x_test)
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    per_stage = _stage_launches(clock)
    stages = []
    for i, h in enumerate(hists):
        score = restart_scores(h)
        best = int(np.argmin(score))
        x, y, _ = _stage_data(torch, dm, "CIGAR", i, device)
        y = y.reshape(len(y), -1)
        gp, p = model.gp_list[i], clock.params[i]["gp"][i]
        with torch.no_grad():
            v_card = float(gp.nll(p, x, y))
        ms = clock.seconds[i] / iters * 1e3
        print(f"CIGAR stage {i}: rows {SIZES[i]} columns {y.shape[1]}  final NLML "
              f"{score[best]:.4f}  chosen restart {best}  wall {clock.seconds[i]:.3f} s "
              f"({ms:.2f} ms/step)  launches {per_stage[i]}", flush=True)
        check(bool(np.isfinite(score[best])), f"CIGAR stage {i} final NLML finite")
        check_stage_nll(torch, f"CIGAR stage {i}", v_card,
                        plain_stage_nll(torch, gp, p, x, y, torch.float32),
                        plain_stage_nll(torch, gp, p, x, y, torch.float64),
                        float(score[best]), x.shape[0])
        stages.append(dict(rows=SIZES[i], ms_per_step=ms, seconds=clock.seconds[i],
                           launches=per_stage[i]))
    check(bool((var > 0).all()), "CIGAR forward: variances > 0")
    rmse, rel = field_metrics("CIGAR", mean, truth.reshape(len(truth), -1))
    cascade_launches("CIGAR", ("gram", "chol", "chol_batched", "tri_inv"), counts)
    print(f"CIGAR launches {counts}", flush=True)
    report["launches_by_path"]["CIGAR"] = counts
    report["kron"]["CIGAR"] = dict(stages=stages, rmse=rmse, rel_err=rel)


def kron_nan_isolation(torch, device):
    """A 4-restart HOGP batch (n = 512, output (16, 16), ARD with a dim-1
    length scale against d = 4) whose restart 2 has NaN parameters:
    `nll` is NaN for that restart only and raises nothing (cuSOLVER's
    ``eigh`` never sees the NaN Gram), and a 5-step `fit_restarts` returns
    finite params of another restart."""
    from fidelityfusion_tpu_torch.models.hogp import HOGP
    from fidelityfusion_tpu_torch.ops.kernels import ARDKernel
    from fidelityfusion_tpu_torch.train.fit import fit_restarts, stack_params
    from fidelityfusion_tpu_torch.utils.tree import tree_leaves

    gen = torch.Generator().manual_seed(13)
    x = torch.rand((512, 4), generator=gen).to(device)
    y = torch.randn((512, 16, 16), generator=gen).to(device)
    hogp = HOGP(ARDKernel(), (16, 16))
    p = hogp.init_params(4, device=device)
    batch = stack_params([p] * 4)
    batch["kernel"]["length_scales"] = torch.tensor([[1.0], [0.5], [float("nan")], [2.0]],
                                                    device=device)
    with torch.no_grad():
        v = hogp.nll(batch, x, y).cpu()
    ok = bool(torch.isnan(v[2])) and bool(torch.isfinite(v[[0, 1, 3]]).all())
    best, res = fit_restarts(hogp.nll, batch, steps=5, lr=5e-2, loss_args=(x, y))
    fin = all(bool(torch.isfinite(a).all()) for a in tree_leaves(best))
    print(f"NaN isolation: nll per restart {v.tolist()}; 5-step fit_restarts losses "
          f"{res.losses[:, -1].cpu().tolist()}", flush=True)
    check(ok and fin, "NaN isolation on the Kronecker path: NaN for restart 2 only, no "
                      "exception, fit_restarts returns finite params")


def kron_paths(torch, device, iters, report):
    """Phase 5: the Kronecker path, each driven with the launch counts set
    to 0 just before it and read just after."""
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "Kronecker phase: TF32 off (allow_tf32 False, float32_matmul_precision highest)")
    report["kron"] = {}
    hogp1024_path(torch, device, report)
    gar_path(torch, device, iters, report)
    cigar_path(torch, device, iters, report)
    kron_nan_isolation(torch, device)


# --------------------------------------------------------------------------
# Phase 6: joint and legacy training, the float64 island
# --------------------------------------------------------------------------


def _falling(losses) -> bool:
    """The JAX tests' check of a joint history: its last finite loss below
    its first (the NaN rollback may truncate late steps)."""
    finite = losses[losses.isfinite()]
    return len(finite) > 1 and bool(finite[-1] < finite[0])


def _timed_run(torch, fn):
    """(result, seconds, launch counts) of ``fn()`` with the counts set to 0
    just before it and read just after, synchronized."""
    from fidelityfusion_tpu_torch.ops import cuda

    cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t, cuda.launch_counts()


def joint_cascade(torch, device, name, nonsubset, iters, report):
    """`train_joint` of one cascade on the main path's data (``nonsubset``:
    the toy's independent designs at `SIZES` rows, 4 rounds of staged
    imputation), then `forward` on the 1000 test points: the loss history's
    last finite value below its first, RMSE vs sin(x) under the JAX tests'
    bar (0.35; CAR 0.5), each stage's NLML at the final parameters against
    the plain versions in float32 and float64, K1, K2 and K3b launched."""
    import numpy as np

    from fidelityfusion_tpu_torch.demo import _toy_3fid
    from fidelityfusion_tpu_torch.models import ar, car, nar, resgp
    from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager
    from fidelityfusion_tpu_torch.models.joint import train_joint
    from fidelityfusion_tpu_torch.ops.kernels import ARDKernel, SquaredExponentialKernel

    label = f"joint {name}{' nonsubset' if nonsubset else ''}"
    if nonsubset:
        xs, ys, x_test, y_test = _toy_3fid(seed=1, nonsubset=True, sizes=SIZES, n_test=1000)
        dm = MultiFidelityDataManager([
            {"raw_fidelity_name": str(i), "fidelity_indicator": i, "X": x, "Y": y}
            for i, (x, y) in enumerate(zip(xs, ys))])
    else:
        _, dm, x_test, y_test = main_path_setup(device)
    cls, kernel, lr = {"AR": (ar.AR, SquaredExponentialKernel, 5e-2),
                       "ResGP": (resgp.ResGP, SquaredExponentialKernel, 5e-2),
                       "NAR": (nar.NAR, SquaredExponentialKernel, 5e-2),
                       "CAR": (car.ContinuousAutoRegression, ARDKernel, 2e-2)}[name]
    kw = {"if_nonsubset": True} if nonsubset else {}
    model = cls(3, [kernel() for _ in range(3)], device=device, **kw)

    def run():
        losses = train_joint(model, dm, max_iter=iters, lr_init=lr, rounds=4)
        with torch.no_grad():
            return losses, model.forward(dm, x_test)

    (losses, (mean, cov)), sec, counts = _timed_run(torch, run)
    losses = losses.cpu()
    steps = losses.shape[0]
    mean_np = mean.cpu().numpy()
    rmse = float(np.sqrt(np.mean((mean_np - y_test) ** 2)))
    bar = 0.5 if name == "CAR" else 0.35
    print(f"{label}: {steps} joint steps over (1024, 512, 256)-row stages: loss {losses[0]:.4f} "
          f"-> {losses[-1]:.4f}, wall {sec:.3f} s with forward ({sec / steps * 1e3:.2f} ms/step), "
          f"test RMSE vs sin(x) {rmse:.5f}, launches {counts}", flush=True)
    check(_falling(losses), f"{label}: last finite loss below the first")
    check(bool(np.isfinite(mean_np).all()) and mean_np.shape == (1000, 1)
          and cov.shape == (1000, 1000), f"{label} forward: finite mean (1000, 1), cov "
                                         f"(1000, 1000)")
    check(rmse < bar, f"{label} test RMSE {rmse:.5f} < {bar}")
    for i in range(3):
        gp, p = model.gp_list[i], model.params["gp"][i]
        if name == "CAR" and i > 0:
            p = car._bind_b(p, model.params["b"])
        x, y, y_var = _stage_data(torch, dm, name, i, device)
        with torch.no_grad():
            v_card = float(gp.nll(p, x, y, y_var=y_var))
        check_stage_nll(torch, f"{label} stage {i}", v_card,
                        plain_stage_nll(torch, gp, p, x, y, torch.float32, y_var),
                        plain_stage_nll(torch, gp, p, x, y, torch.float64, y_var),
                        None, x.shape[0])
    cascade_launches(label, ("gram", "chol", "tri_inv"), counts)
    report["launches_by_path"][label] = counts
    report["joint"][label] = dict(steps=steps, seconds=sec, ms_per_step=sec / steps * 1e3,
                                  rmse=rmse, final_loss=float(losses[-1]))


def joint_field_stage(torch, model, dm, i):
    """(x, y, y_var) of stage i of a jointly trained GAR or CIGAR as its
    joint loss sees them at the final parameters: fidelity 0's data; a
    subset stage's registered residual (no variance); a non-subset stage's
    targets imputed anew by the trained cascade, its residual and the
    variance ``|var_hi - var_lo| / scale^2`` on the diagonal, built as
    `models/joint.py` builds them (the registered ``res-i`` carries no
    variance)."""
    from fidelityfusion_tpu_torch.models import joint
    from fidelityfusion_tpu_torch.models.ar import _f32

    dev = model.device
    if i == 0:
        return (*joint._tensor_x0(model, dm), None)
    if not model.if_nonsubset:
        x, (y, _) = dm.get_data_by_name(f"res-{i}")
        y = _f32(y, dev)
        return _f32(x, dev), (y if hasattr(model, "hogp_list") else y.reshape(len(y), -1)), None
    sx, y_low_p, y_high_p = dm.get_nonsubset_fill_data(model, i - 1, i)
    sx = _f32(sx, dev)
    yl, yh = joint._tensor_targets(model, i, sx, _f32(y_low_p[0], dev), _f32(y_high_p[0], dev))
    shift, scale = model.stage_norm[i]
    with torch.no_grad():
        res = (yh - joint._tensor_lift(model, i, model.params["tl"][i - 1], yl) - shift) / scale
    rv = torch.abs(_f32(y_high_p[1], dev) - _f32(y_low_p[1], dev)).reshape(-1)
    return sx, res, rv / torch.tensor(scale, dtype=torch.float32) ** 2


def joint_field(torch, device, name, nonsubset, iters, report):
    """`train_joint` of GAR (exact `eigh` of every stage's K_0 each step)
    or CIGAR over ARD kernels on the Poisson fields at `SIZES` rows (3
    rounds non-subset), `forward` on the 128 test samples: the last finite
    loss below the first, relative error < 0.6 (subset) / 0.8 (non-subset)
    (the JAX tests' bars), variances > 0, each stage's NLML through the
    kernels against the plain versions; GAR launches K1, CIGAR K1, K2 and
    K3b."""
    import numpy as np

    from fidelityfusion_tpu_torch.models.cigar import CIGAR
    from fidelityfusion_tpu_torch.models.gar import GAR
    from fidelityfusion_tpu_torch.models.joint import train_joint
    from fidelityfusion_tpu_torch.ops.kernels import ARDKernel

    label = f"joint {name}{' nonsubset' if nonsubset else ''}"
    dm, shapes, x_test, truth = field_setup(device, flat=name == "CIGAR", nonsubset=nonsubset)
    cls = GAR if name == "GAR" else CIGAR
    model = cls(3, [ARDKernel() for _ in range(3)], shapes, input_dim=4, device=device,
                if_nonsubset=nonsubset)

    def run():
        losses = train_joint(model, dm, max_iter=iters, lr_init=5e-2, rounds=3)
        with torch.no_grad():
            return losses, model.forward(dm, x_test)

    (losses, (mean, var)), sec, counts = _timed_run(torch, run)
    losses = losses.cpu()
    steps = losses.shape[0]
    print(f"{label}: {steps} joint steps: loss {losses[0]:.5f} -> {losses[-1]:.5f}, wall "
          f"{sec:.3f} s with forward ({sec / steps * 1e3:.2f} ms/step), launches {counts}",
          flush=True)
    check(_falling(losses), f"{label}: last finite loss below the first")
    check(bool((var > 0).all()), f"{label} forward: variances > 0")
    truth = truth if name == "GAR" else truth.reshape(len(truth), -1)
    rmse, rel = field_metrics(label, mean, truth, bar=0.8 if nonsubset else 0.6)
    for i in range(3):
        x, y, y_var = joint_field_stage(torch, model, dm, i)
        if name == "GAR":
            hogp, p = model.hogp_list[i], model.params["hogp"][i]
            with torch.no_grad():
                v_card = float(hogp.nll(p, x, y, y_var))
            check_kron_nll(f"{label} stage {i}", v_card,
                           plain_kron_nll(torch, hogp, p, x, y, y_var, dtype=torch.float32),
                           plain_kron_nll(torch, hogp, p, x, y, y_var))
        else:
            gp, p = model.gp_list[i], model.params["gp"][i]
            with torch.no_grad():
                v_card = float(gp.nll(p, x, y, y_var=y_var))
            check_stage_nll(torch, f"{label} stage {i}", v_card,
                            plain_stage_nll(torch, gp, p, x, y, torch.float32, y_var),
                            plain_stage_nll(torch, gp, p, x, y, torch.float64, y_var), None,
                            x.shape[0])
    cascade_launches(label, ("gram",) if name == "GAR" else ("gram", "chol", "tri_inv"), counts)
    report["launches_by_path"][label] = counts
    report["joint"][label] = dict(steps=steps, seconds=sec, ms_per_step=sec / steps * 1e3,
                                  rmse=rmse, rel_err=rel, final_loss=float(losses[-1]))


def legacy_paths(torch, device, report):
    """The legacy wrappers at the main path's width: `LegacyCIGP` fit for
    100 steps to 1024 rows of the toy's fidelity 0, then `forward` on the
    1000 test points (RMSE vs that fidelity's function < 0.15, the JAX
    test's bar); `LegacyHOGP` `compute_loss` and `forward` on GAR's stage-0
    fields (1024 rows, (8, 8)); `LegacyFIDES` at bounds (0, 1, 0, 1) fit for
    `FIT_STEPS` steps to 1024 standardized top-fidelity rows, `forward` on
    the test points (RMSE < 0.2).  Finite losses, variances > 0; CIGP and
    FIDES launch K1, K2 and K3b, HOGP K1."""
    import numpy as np

    from fidelityfusion_tpu_torch.demo import _toy_3fid
    from fidelityfusion_tpu_torch.models.legacy import LegacyCIGP, LegacyFIDES, LegacyHOGP

    xs, ys, x_test, _ = _toy_3fid(seed=1, sizes=SIZES, pool=2048, n_test=1000, nested=True)
    f0 = np.sin(x_test) - 0.5 * np.sin(2 * x_test)
    gp = LegacyCIGP({"input_dim": 1}, device=device)

    def run_cigp():
        losses = gp.fit(xs[0], ys[0], max_iter=100, lr=5e-2)
        return losses, gp.forward(x_test)

    (losses, (mean, var)), sec, counts = _timed_run(torch, run_cigp)
    losses = losses.cpu()
    rmse = float(np.sqrt(np.mean((mean.cpu().numpy() - f0) ** 2)))
    print(f"LegacyCIGP: 100 steps over 1024 rows: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"wall {sec:.3f} s with forward ({sec / 100 * 1e3:.2f} ms/step), RMSE vs fidelity 0 "
          f"{rmse:.5f}, launches {counts}", flush=True)
    check(bool(torch.isfinite(losses).all()) and losses[-1] < losses[0]
          and mean.shape == (1000, 1) and var.shape == (1000, 1) and bool((var > 0).all()),
          "LegacyCIGP: finite falling losses, mean (1000, 1), variances (1000, 1) > 0")
    check(rmse < 0.15, f"LegacyCIGP RMSE {rmse:.5f} < 0.15")
    with torch.no_grad():
        check_stage_nll(torch, "LegacyCIGP", float(gp.compute_loss(gp.train_x, gp.train_y)),
                        plain_stage_nll(torch, gp.core, gp.params, gp.train_x, gp.train_y,
                                        torch.float32),
                        plain_stage_nll(torch, gp.core, gp.params, gp.train_x, gp.train_y,
                                        torch.float64), float(losses[-1]), SIZES[0])
    cascade_launches("LegacyCIGP", ("gram", "chol", "tri_inv"), counts)
    report["launches_by_path"]["LegacyCIGP"] = counts
    report["legacy"] = {"LegacyCIGP": dict(seconds=sec, ms_per_step=sec / 100 * 1e3, rmse=rmse)}

    dm, shapes, fx_test, _ = field_setup(device)
    fx, fy = dm.get_data(0, normal=False)
    hogp = LegacyHOGP({"input_dim": 4, "output_shape": shapes[0], "kernel": {"ARD": {}}},
                      device=device)

    def run_hogp():
        with torch.no_grad():
            return hogp.compute_loss(fx, fy), hogp.forward(fx_test)

    (loss, (hmean, hvar)), sec, counts = _timed_run(torch, run_hogp)
    print(f"LegacyHOGP: compute_loss {float(loss):.6f} and forward on 128 samples of "
          f"{shapes[0]} fields: {sec:.3f} s, launches {counts}", flush=True)
    check(bool(torch.isfinite(loss)) and hmean.shape == (128,) + shapes[0]
          and bool(torch.isfinite(hmean).all()) and bool((hvar > 0).all()),
          "LegacyHOGP: finite loss and mean, variances > 0")
    check_kron_nll("LegacyHOGP", float(loss),
                   plain_kron_nll(torch, hogp.core, hogp.params, hogp.train_x, hogp.train_y,
                                  dtype=torch.float32),
                   plain_kron_nll(torch, hogp.core, hogp.params, hogp.train_x, hogp.train_y))
    cascade_launches("LegacyHOGP", ("gram",), counts)
    report["launches_by_path"]["LegacyHOGP"] = counts
    report["legacy"]["LegacyHOGP"] = dict(seconds=sec)

    xs, ys, x_test, y_test = _toy_3fid(seed=1, sizes=(1024,) * 3, pool=2048, n_test=1000,
                                       nested=True)
    xm, xsd, ym, ysd = xs[2].mean(), xs[2].std(), ys[2].mean(), ys[2].std()
    fides = LegacyFIDES(device=device)
    fides.set_fidelity(0, 1, 0, 1)

    def run_fides():
        losses = fides.fit((xs[2] - xm) / xsd, (ys[2] - ym) / ysd, max_iter=FIT_STEPS, lr=5e-2)
        return losses, fides.forward((x_test - xm) / xsd)

    (losses, (fmean, fvar)), sec, counts = _timed_run(torch, run_fides)
    losses = losses.cpu()
    rmse = float(np.sqrt(np.mean((fmean.cpu().numpy() * ysd + ym - y_test) ** 2)))
    print(f"LegacyFIDES: {FIT_STEPS} steps over 1024 rows: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, wall {sec:.3f} s with forward ({sec / FIT_STEPS * 1e3:.2f} "
          f"ms/step), RMSE {rmse:.5f}, launches {counts}", flush=True)
    check(bool(torch.isfinite(losses).all()) and losses[-1] < losses[0]
          and bool((fvar > 0).all()), "LegacyFIDES: finite falling losses, variances > 0")
    check(rmse < 0.2, f"LegacyFIDES RMSE {rmse:.5f} < 0.2")
    cascade_launches("LegacyFIDES", ("gram", "chol", "tri_inv"), counts)
    report["launches_by_path"]["LegacyFIDES"] = counts
    report["legacy"]["LegacyFIDES"] = dict(seconds=sec, ms_per_step=sec / FIT_STEPS * 1e3,
                                           rmse=rmse)


def x64_path(torch, device, report):
    """`CIGP(x64_factor=True)` at n = 1024: `tests/test_cigp.py`'s escape
    hatch at the main path's width (SE at unit length scale and signal,
    noise 1e-5, jitter 0, no floor, x uniform on [0, 20]: cond(Sigma) ~1e7,
    beyond float32).  The NLML within 1e-10 (relative) of a float64
    recomputation with numpy (direct differences, LAPACK); 20 Adam steps
    finite and not rising; the posterior mean within 1e-3 of the float64
    closed form (the JAX test's bar), variances > 0.  The island is plain
    float64 PyTorch (cuSOLVER): no float32 kernel may launch in it."""
    import numpy as np
    import scipy.linalg as sla

    from fidelityfusion_tpu_torch.models.cigp import CIGP
    from fidelityfusion_tpu_torch.ops.kernels import SquaredExponentialKernel
    from fidelityfusion_tpu_torch.train.fit import fit

    rng = np.random.default_rng(0)
    n, noise = SIZES[0], 1e-5
    x = (rng.random((n, 1)) * 20).astype(np.float32)
    y = np.sin(x).astype(np.float32)
    xt = np.linspace(0, 20, 64).reshape(-1, 1).astype(np.float32)
    gp = CIGP(kernel=SquaredExponentialKernel(), jitter=0.0, min_noise=0.0, x64_factor=True)
    p = {"kernel": {"length_scale": torch.zeros(1, device=device),
                    "signal_variance": torch.zeros(1, device=device)},
         "log_beta": torch.tensor([-np.log(noise)], dtype=torch.float32, device=device)}
    tx, ty, txt = (torch.as_tensor(a, device=device) for a in (x, y, xt))

    def run():
        with torch.no_grad():
            v = float(gp.nll64(p, tx, ty))
        res = fit(gp.nll, p, steps=20, lr=1e-2, loss_args=(tx, ty))
        with torch.no_grad():
            return v, res.losses, gp.predict_diag(p, tx, ty, txt)

    (v, losses, (mean, var)), sec, counts = _timed_run(torch, run)
    losses = losses.cpu()
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    nz = float(torch.exp(-p["log_beta"][0]).cpu())  # the float32 noise, as the island's
    L = np.linalg.cholesky(np.exp(-0.5 * (x64 - x64.T) ** 2) + nz * np.eye(n))
    a = sla.solve_triangular(L, y64, lower=True)
    ref = float(0.5 * (a * a).sum() + np.log(np.diag(L)).sum() + 0.5 * n * np.log(2 * np.pi))
    rel = abs(v - ref) / abs(ref)
    alpha = sla.cho_solve((L, True), y64)
    m_ref = np.exp(-0.5 * (x64 - xt.astype(np.float64).T) ** 2).T @ alpha
    merr = float(np.abs(mean.cpu().numpy() - m_ref).max())
    print(f"CIGP x64: n={n} NLML float64 {v:.10f} vs numpy {ref:.10f} (rel {rel:.2e}); 20 steps "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; posterior mean vs closed form {merr:.2e}; "
          f"{sec:.3f} s; launches {counts}", flush=True)
    check(rel <= 1e-10, f"CIGP x64: NLML vs float64 recomputation rel {rel:.2e} (<= 1e-10)")
    check(bool(torch.isfinite(losses).all()) and losses[-1] <= losses[0],
          "CIGP x64: 20 steps finite, not rising")
    check(merr <= 1e-3 and bool((var > 0).all()),
          f"CIGP x64: posterior mean within {merr:.2e} of the float64 closed form (<= 1e-3), "
          f"variances > 0")
    check(not any(counts.values()), "CIGP x64: no float32 kernel launched in the float64 island")
    report["launches_by_path"]["CIGP x64"] = counts
    report["legacy"]["CIGP x64"] = dict(seconds=sec, nll_rel_err=rel, mean_err=merr)


def joint_legacy_paths(torch, device, iters, report):
    """Phase 6: joint training, the legacy wrappers and the float64 island,
    each path with its own launch counts; prints the phase's wall."""
    t = time.perf_counter()
    report["joint"] = {}
    for nonsubset in (False, True):
        for name in ("AR", "ResGP", "NAR") + (() if nonsubset else ("CAR",)):
            joint_cascade(torch, device, name, nonsubset, iters, report)
    for name in ("GAR", "CIGAR"):
        for nonsubset in (False, True):
            joint_field(torch, device, name, nonsubset, iters, report)
    legacy_paths(torch, device, report)
    x64_path(torch, device, report)
    print(f"joint and legacy phase: {time.perf_counter() - t:.1f} s", flush=True)


def unbatched_paths(torch, device):
    """20-step SE and ARD CIGP fits at n = 2048; returns ms/step of each."""
    from fidelityfusion_tpu_torch.demo import _toy_3fid
    from fidelityfusion_tpu_torch.models.cigp import CIGP
    from fidelityfusion_tpu_torch.ops import cuda
    from fidelityfusion_tpu_torch.ops.kernels import ARDKernel, SquaredExponentialKernel
    from fidelityfusion_tpu_torch.train.fit import fit

    xs, ys, _, _ = _toy_3fid(seed=2, sizes=(2048, 1, 1), pool=4096)
    x = torch.as_tensor(((xs[0] - xs[0].mean()) / xs[0].std()).astype("float32"), device=device)
    y = torch.as_tensor(((ys[0] - ys[0].mean()) / ys[0].std()).astype("float32"), device=device)
    ms_per_step = {}
    for name, kernel in (("se_nlml (SE)", SquaredExponentialKernel()),
                         ("mvn_nll_hybrid (ARD)", ARDKernel())):
        gp = CIGP(kernel=kernel)
        before = cuda.launch_counts().get("chol", 0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fit(gp.nll, gp.init_params(1, device=device), steps=20, lr=5e-2,
                  loss_args=(x, y))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        losses = res.losses.cpu()
        k2 = cuda.launch_counts().get("chol", 0) - before
        ms_per_step[name] = sec / 20 * 1e3
        print(f"unbatched {name} n=2048: NLML {losses[0]:.4f} -> {losses[-1]:.4f}, "
              f"{sec / 20 * 1e3:.2f} ms/step, K2 launches {k2}", flush=True)
        check(bool(torch.isfinite(losses).all()) and losses[-1] < losses[0] and k2 >= 20,
              f"unbatched {name}: finite, decreasing, through K2")
    return ms_per_step


BO_RUNS = (("UCB", 0), ("UCB", 1), ("UCB", 2), ("EI", 0), ("ES", 0), ("cfKG", 0))
# final-incumbent bars (Forrester's top-fidelity maximum is 15.83): 15.0,
# or the JAX loop's own final less 0.3 where that run ends under 15.0 from
# the same seed and design (`scripts/mfbo_jax_bars.py`: ES seed 0 ends at
# 14.5656 on the CPU)
BO_BARS = {"UCB": 15.0, "EI": 15.0, "ES": 14.2656, "cfKG": 15.0}


def _bo_record_checks(label, rec, n_iter):
    import numpy as np

    inc, cost = rec["incumbents"], rec["cost"]
    check(len(inc) == n_iter and all(b >= a for a, b in zip(inc, inc[1:])),
          f"{label}: {len(inc)} iterations, incumbents never decrease")
    check(all(b > a for a, b in zip(cost, cost[1:])), f"{label}: cost grows every iteration")
    check(all(bool(np.isfinite(np.asarray(rec[k], float)).all())
              for k in ("X", "incumbents", "cost", "operation_time")),
          f"{label}: every value finite")


def _median(a) -> float:
    import numpy as np

    return float(np.median(np.asarray(a, float)))


def bo_card_vs_cpu(torch, device, report):
    """One UCB iteration (iteration 0, seed 0) on the card and with
    ``device="cpu"``: the same fidelity, and the CPU's acquisition at the
    card's x within 1e-3 (relative) of the CPU's best.  Then, on the card's
    surrogate: ms per acquisition Adam step (K1 forward and backward per
    stage a step, `gram_plain` never called) and the `ARPosterior` query
    latency at 16 and 1000 points by CUDA events."""
    import math

    import numpy as np

    from fidelityfusion_tpu_torch.bo.loop import acquire, fit_surrogate, generator
    from fidelityfusion_tpu_torch.bo.optimize import optimize_acqf
    from fidelityfusion_tpu_torch.data.objectives import Forrester
    from fidelityfusion_tpu_torch.ops import cuda

    f = Forrester(2)
    xs, ys = f.initiate_data({1: 10, 2: 4}, 0)
    beta = 0.2 * f.x_dim * math.log(1.1)
    f_best = float(max(np.max(y) for y in ys))
    bounds = np.asarray(f.search_range[: f.x_dim], float)
    out = []
    for dev in (torch.device("cpu"), device):
        model, dm = fit_surrogate(f, list(xs), list(ys), device=dev)
        out.append(acquire(model, dm, "UCB", beta, f_best, bounds, [0.01, 0.01],
                           generators=[generator(0, 0, s) for s in range(2)]))
    (x_cpu, s_cpu, v_cpu, scores_cpu), (x_card, s_card, v_card, scores_card) = out
    with torch.no_grad():  # the acquisition of x: its best score over the fidelities
        v_at_card = max(float(score(torch.as_tensor(x_card), state, torch.tensor(f_best)))
                        for score, state in scores_cpu)
    rel = abs(v_at_card - v_cpu) / max(abs(v_cpu), 1e-12)
    print(f"BO one UCB iteration: card x {x_card.ravel().tolist()} s {s_card} value {v_card:.6f}; "
          f"cpu x {x_cpu.ravel().tolist()} s {s_cpu} value {v_cpu:.6f}; the CPU's acquisition "
          f"at the card's x {v_at_card:.6f} ({rel:.2e} relative)", flush=True)
    check(s_card == s_cpu, f"BO card vs cpu: the same fidelity ({s_card}, {s_cpu})")
    check(rel <= 1e-3, f"BO card vs cpu: the CPU's acquisition at the card's x within 1e-3 "
                       f"of its best ({rel:.2e})")

    # one acquisition ascent on the card: 30 Adam steps from 16 starts
    score, state = scores_card[1]
    f_best_t = torch.tensor(f_best, device=device)
    with PlainCalls() as plain:
        cuda.reset_launch_counts()
        optimize_acqf(score, bounds, generator(0, 99), raw_samples=16, steps=30,
                      acq_args=(state, f_best_t), device=device)
        torch.cuda.synchronize()
        k1 = cuda.launch_counts().get("gram", 0)
    stages = len(state["stages"])
    check(k1 == 30 * 2 * stages + stages and not any(plain.calls.values()),
          f"BO acquisition ascent: K1 {k1} launches (forward and backward of {stages} stages "
          f"a step, {30 * 2 * stages + stages} expected), plain versions called {plain.calls}")
    t = time.perf_counter()
    reps = 5
    for r in range(reps):
        optimize_acqf(score, bounds, generator(0, 100 + r), raw_samples=16, steps=30,
                      acq_args=(state, f_best_t), device=device)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t) / (reps * 30) * 1e3
    latency = {}
    with torch.no_grad():
        for m in (16, 1000):
            xq = torch.rand((m, 1), generator=torch.Generator().manual_seed(m)).to(device)
            latency[m] = timed(lambda: score.posterior(state, xq), torch)
    print(f"BO acquisition: {ms_step:.3f} ms per Adam step (16 starts, {stages} stages, host "
          f"clock over {reps} x 30 steps); ARPosterior query latency {latency[16] * 1e3:.1f} us "
          f"at 16 points, {latency[1000] * 1e3:.1f} us at 1000 (CUDA events)", flush=True)
    report["bo"]["acq_ms_per_step"] = ms_step
    report["bo"]["query_ms"] = {str(m): v for m, v in latency.items()}


def bo_paths(torch, device, report):
    """Phase 8: multi-fidelity BO.  `mf_bo_discrete` on Forrester(2) with
    the AR surrogate, 10 iterations from the {1: 10, 2: 4} design at the
    loop's defaults (UCB on seeds 0, 1 and 2; EI, ES and cfKG on seed 0);
    `mf_bo_continuous` on Branin (UCB, ES, KG, seed 0); each run with the
    launch counts set to 0 just before it and read just after."""
    from fidelityfusion_tpu_torch.bo.continuous_loop import mf_bo_continuous
    from fidelityfusion_tpu_torch.bo.loop import mf_bo_discrete
    from fidelityfusion_tpu_torch.data.objectives import Branin, Forrester

    t = time.perf_counter()
    report["bo"] = {"finals": {}}
    finals = report["bo"]["finals"]
    for method, seed in BO_RUNS:
        label = f"BO discrete {method} seed {seed}"
        rec, sec, counts = _timed_run(torch, lambda: mf_bo_discrete(
            Forrester(2), method=method, model_name="AR", bo_iterations=10,
            init_index={1: 10, 2: 4}, seed=seed, device=device))
        _bo_record_checks(label, rec, 10)
        cascade_launches(label, ("gram", "chol", "chol_batched", "tri_inv"), counts)
        report["launches_by_path"][label] = counts
        finals[label] = rec["incumbents"][-1]
        print(f"{label}: S {rec['S']}, incumbents {[round(v, 4) for v in rec['incumbents']]}, "
              f"cost {rec['cost'][-1]:.0f}; {sec:.2f} s, median s/iteration "
              f"{_median(rec['operation_time']):.3f} (train {_median(rec['train_time']):.3f}, "
              f"acquisition {_median(rec['acq_time']):.3f}); launches {counts}", flush=True)
        report["bo"][label] = {k: _median(rec[k]) for k in
                               ("operation_time", "train_time", "acq_time")}
    ucb = sorted(finals[f"BO discrete UCB seed {s}"] for s in (0, 1, 2))
    check(ucb[1] >= BO_BARS["UCB"],
          f"BO discrete UCB: median final incumbent {ucb[1]:.4f} >= {BO_BARS['UCB']}")
    for method in ("EI", "ES", "cfKG"):
        v = finals[f"BO discrete {method} seed 0"]
        check(v >= BO_BARS[method],
              f"BO discrete {method}: final incumbent {v:.4f} >= {BO_BARS[method]}")
    for method in ("UCB", "ES", "KG"):
        label = f"BO continuous {method}"
        rec, sec, counts = _timed_run(torch, lambda: mf_bo_continuous(
            Branin(), method=method, bo_iterations=10, seed=0, device=device))
        _bo_record_checks(label, rec, 10)
        check(all(0.1 <= z <= 1.0 for z in rec["Z"]), f"{label}: every z in [0.1, 1]")
        cascade_launches(label, ("gram", "chol", "tri_inv"), counts)
        report["launches_by_path"][label] = counts
        finals[label] = rec["incumbents"][-1]
        print(f"{label}: Z {[round(z, 3) for z in rec['Z']]}, incumbents "
              f"{[round(v, 4) for v in rec['incumbents']]}; {sec:.2f} s, median s/iteration "
              f"{_median(rec['operation_time']):.3f} (train {_median(rec['train_time']):.3f}, "
              f"acquisition {_median(rec['acq_time']):.3f}); launches {counts}", flush=True)
        report["bo"][label] = {k: _median(rec[k]) for k in
                               ("operation_time", "train_time", "acq_time")}
    bo_card_vs_cpu(torch, device, report)
    print(f"BO phase: {time.perf_counter() - t:.1f} s; final incumbents {finals}", flush=True)


SWEEP_METHODS = ("AR", "ResGP", "NAR", "CAR", "GAR", "CIGAR")
SWEEP_N_HIGH = (4, 8, 16, 32)
# the JAX harness's RMSE on each cell the bars hold (`scripts/sweep_jax_bars.py`,
# on the CPU): grid forrester12 seed 0 at the harness's defaults (CAR at
# lr 1e-2, `SWEEP_LR`), and the field protocol (Poisson, non-aligned,
# resolutions (8, 16)) at n_high 32
SWEEP_JAX_RMSE = {
    "grid AR 16": 0.0765070462497497, "grid AR 32": 0.05722183214987079,
    "grid ResGP 16": 0.13129789923037805, "grid ResGP 32": 0.07343905730065985,
    "grid NAR 16": 0.6913885825587952, "grid NAR 32": 0.8425537141799044,
    "grid CAR 16": 0.12592339192389215, "grid CAR 32": 0.0744827445317785,
    "grid GAR 16": 1.2630750139780471, "grid GAR 32": 0.7943589255342116,
    "grid CIGAR 16": 0.08056134611723953, "grid CIGAR 32": 0.05722183931300523,
    "field GAR 32": 0.0010450848623144993, "field CIGAR 32": 0.00048792246738334964,
}
# staged CAR at `train_CAR`'s lr: at the grid's 5e-2 its restarts do not
# settle (stage-0 finals from -200 to -351 by restart, moving with 1e-7 of
# the data; the card's n_high 32 cell ended at RMSE 0.240, the CPU's at
# 0.033, the JAX harness's at 0.026: `scripts/car_lr_probe.py`)
SWEEP_LR = {"CAR": 1e-2}
SWEEP_COLUMNS = ["train_sample_num", "rmse", "nrmse", "r2", "nll", "time"]


def _sweep_csv_checks(label, path, n_rows):
    """The reference CSV: its header, ``n_rows`` rows, every metric finite."""
    import csv

    import numpy as np

    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    check(rows[0] == SWEEP_COLUMNS, f"{label}: CSV header {','.join(rows[0])}")
    vals = np.asarray(rows[1:], float)
    check(vals.shape == (n_rows, len(SWEEP_COLUMNS)) and bool(np.isfinite(vals).all()),
          f"{label}: {len(rows) - 1} rows (want {n_rows}), every metric finite")


def _sweep_bar(label, rmse, key, y_test):
    """RMSE <= 1.25 x the JAX harness's on the same cell + 0.01 std(y_test)."""
    bar = 1.25 * SWEEP_JAX_RMSE[key] + 0.01 * float(y_test.std())
    check(rmse <= bar, f"{label}: RMSE {rmse:.5f} <= {bar:.5f} (1.25 x JAX "
                       f"{SWEEP_JAX_RMSE[key]:.5f} + 0.01 std(y_test))")


def sweep_paths(torch, device, out, report):
    """The grid protocol at the reference's own sizes (forrester12, seed 0,
    n_high 4-32, the harness's defaults, CAR at lr 1e-2) for every method,
    then the field protocol (GAR, CIGAR on Poisson, non-aligned,
    resolutions (8, 16), n_high 8 and 32), each method's sweep with the
    launch counts set to 0 just before it and read just after; one AR cell
    again with ``device="cpu"``."""
    from fidelityfusion_tpu_torch.experiments import load_mfdata, sweep

    rep = report["experiments"]
    y_test = {n: load_mfdata.load_data("forrester12", n_train_high=n, seed=0)["y_test"]
              for n in SWEEP_N_HIGH}
    for method in SWEEP_METHODS:
        label = f"sweep grid {method}"
        rows, sec, counts = _timed_run(torch, lambda: sweep.run_sweep(
            [method], ["forrester12"], seeds=(0,), n_high_grid=SWEEP_N_HIGH, outdir=out,
            lr=SWEEP_LR.get(method, 5e-2), device=device))
        report["launches_by_path"][label] = counts
        _sweep_csv_checks(label, Path(out) / "forrester12" / f"{method}_seed_0.csv", 4)
        cascade_launches(label, ("gram",) if method == "GAR" else
                         ("gram", "chol_batched", "tri_inv"), counts)
        for row in rows:
            if row["n_high"] >= 16:
                _sweep_bar(f"{label} n_high {row['n_high']}", row["rmse"],
                           f"grid {method} {row['n_high']}", y_test[row["n_high"]])
        walls = [row["time"] for row in rows]
        rep[label] = {"median_cell_s": _median(walls), "seconds": sec,
                      "rmse": [row["rmse"] for row in rows]}
        print(f"{label}: RMSE by n_high {[round(r['rmse'], 5) for r in rows]}; cell walls "
              f"{[round(w, 3) for w in walls]} s (median {_median(walls):.3f}); {sec:.2f} s; "
              f"launches {counts}", flush=True)
        if method == "AR":
            card = rows[-1]
            cpu = sweep.run_single("AR", "forrester12", 0, 32, device="cpu")
            rel = abs(card["rmse"] - cpu["rmse"]) / cpu["rmse"]
            rep["AR n_high 32 card vs cpu"] = {"card": card["rmse"], "cpu": cpu["rmse"]}
            print(f"sweep AR n_high 32: RMSE card {card['rmse']:.6f}, cpu {cpu['rmse']:.6f} "
                  f"({rel:.2e} relative); cell wall card {card['time']:.3f} s, cpu "
                  f"{cpu['time']:.3f} s", flush=True)
            check(rel <= 0.05, f"sweep AR n_high 32: card and cpu RMSE within 5% ({rel:.2e})")
    fixture = sweep._field_fixture("poisson", 0, 100, 32, 100, "non-aligned", (8, 16))
    for method in ("GAR", "CIGAR"):
        label = f"sweep field {method}"
        rows, sec, counts = _timed_run(torch, lambda: sweep.run_gar_field_sweep(
            methods=(method,), seeds=(0,), n_high_grid=(8, 32), variant="non-aligned",
            resolutions=(8, 16), outdir=out, device=device))
        report["launches_by_path"][label] = counts
        _sweep_csv_checks(label, Path(out) / "poisson_non-aligned" / f"{method}_seed_0.csv", 2)
        cascade_launches(label, ("gram",) if method == "GAR" else
                         ("gram", "chol_batched", "tri_inv"), counts)
        _sweep_bar(f"{label} n_high 32", rows[-1]["rmse"], f"field {method} 32", fixture[-1])
        walls = [row["time"] for row in rows]
        rep[label] = {"median_cell_s": _median(walls), "seconds": sec,
                      "rmse": [row["rmse"] for row in rows]}
        print(f"{label}: RMSE by n_high (8, 32) {[round(r['rmse'], 5) for r in rows]}; cell "
              f"walls {[round(w, 3) for w in walls]} s; {sec:.2f} s; launches {counts}",
              flush=True)


def objective_checks(torch, device, report):
    """`MLPTrainingObjective(2)` and `CNNTrainingObjective(2)` at 4
    hyperparameter rows and s = 1, 2 on the card and with ``device="cpu"``
    (the same seeded data and initial weights): validation accuracies
    within 1/n_val, final validation logits within 1e-3 of their max |.|;
    ms per `get_data` row on the card."""
    import numpy as np

    from fidelityfusion_tpu_torch.data.real_app import CNNTrainingObjective, MLPTrainingObjective

    rep = report["experiments"]
    for cls in (MLPTrainingObjective, CNNTrainingObjective):
        name = cls.__name__
        card, cpu = cls(2, device=device), cls(2, device="cpu")
        rows = card._sample(np.random.default_rng(0), 4)
        n_val = len(cpu.y_val)
        for s in (1, 2):
            errs, accs = [], []
            for a, b in rows:
                lg = card._val_logits(a, b, 10 * s).cpu()
                lc = cpu._val_logits(a, b, 10 * s)
                errs.append((lg - lc).abs().max().item() / lc.abs().max().item())
                accs.append((card.accuracy(lg.to(device)), cpu.accuracy(lc)))
            dacc = max(abs(g - c) for g, c in accs)
            check(max(errs) <= 1e-3 and dacc <= 1.0 / n_val,
                  f"{name} s={s}, 4 rows card vs cpu: logits within {max(errs):.2e} of their "
                  f"max (<= 1e-3), accuracies within {dacc:.4f} (<= 1/{n_val})")
            t = time.perf_counter()
            y = card.get_data(rows, s)
            ms = (time.perf_counter() - t) / len(rows) * 1e3
            check(y.shape == (4, 1) and bool(((y >= 0) & (y <= 1)).all()),
                  f"{name} get_data s={s}: (4, 1) accuracies in [0, 1]")
            rep[f"{name} ms per row s={s}"] = ms
            print(f"{name} s={s} ({10 * s} epochs): {ms:.2f} ms per get_data row on the card "
                  f"(host clock, 4 rows); accuracies {[round(g, 4) for g, _ in accs]}",
                  flush=True)


def experiment_paths(torch, device, report):
    """The experiments phase: the sweep protocols, the real-application
    objectives card against cpu, and `mf_bo_discrete` on the MLP objective
    (AR, 5 iterations from the {1: 10, 2: 4} design) with the launch
    counts set to 0 just before it and read just after."""
    import tempfile

    from fidelityfusion_tpu_torch.bo.loop import mf_bo_discrete
    from fidelityfusion_tpu_torch.data.real_app import MLPTrainingObjective

    t = time.perf_counter()
    report["experiments"] = {}
    with tempfile.TemporaryDirectory() as out:
        sweep_paths(torch, device, out, report)
    objective_checks(torch, device, report)
    label = "BO discrete on MLPTrainingObjective"
    rec, sec, counts = _timed_run(torch, lambda: mf_bo_discrete(
        MLPTrainingObjective(2, device=device), model_name="AR", bo_iterations=5,
        init_index={1: 10, 2: 4}, device=device))
    _bo_record_checks(label, rec, 5)
    check(all(0.0 <= v <= 1.0 for v in rec["incumbents"]),
          f"{label}: every incumbent an accuracy in [0, 1]")
    cascade_launches(label, ("gram", "chol", "chol_batched", "tri_inv"), counts)
    report["launches_by_path"][label] = counts
    report["experiments"][label] = {k: _median(rec[k]) for k in
                                    ("operation_time", "train_time", "acq_time")}
    print(f"{label}: S {rec['S']}, incumbents {[round(v, 4) for v in rec['incumbents']]}, cost "
          f"{rec['cost'][-1]:.0f}; {sec:.2f} s, median s/iteration "
          f"{_median(rec['operation_time']):.3f} (train {_median(rec['train_time']):.3f}, "
          f"acquisition {_median(rec['acq_time']):.3f}); launches {counts}", flush=True)
    report["experiments"]["seconds"] = time.perf_counter() - t
    print(f"experiments phase: {time.perf_counter() - t:.1f} s", flush=True)


# --------------------------------------------------------------------------
# Phase 11: the sharding layer (`fidelityfusion_tpu_torch/parallel/`)
# --------------------------------------------------------------------------

SHARD_RANKS = 4  # phase 11(b): ranks sharing the one card over gloo


CIGP_KERNELS = ("gram", ("chol", "chol_batched"), "tri_inv")  # K1, K2 or K3a, K3b


def sharded_run(torch, label, fn, required, report=None):
    """(result, seconds, launch counts) of ``fn()``, the counts set to 0 just
    before it and read just after; checks that each kernel of ``required``
    (a name, or a tuple of which one suffices) launched and that no plain
    version was called."""
    with PlainCalls() as plain:
        out, sec, counts = _timed_run(torch, fn)
    for k in required:
        names = k if isinstance(k, tuple) else (k,)
        n = sum(counts.get(name, 0) for name in names)
        check(n > 0, f"{label}: launched {' or '.join(names)} ({n} times)")
    check(not any(plain.calls.values()), f"{label}: plain versions called 0 times "
                                         f"({plain.calls})")
    if report is not None:
        report["launches_by_path"][label] = counts
    return out, sec, counts


def _value_grad(torch, fn, params):
    """(value, [gradient leaves]) of a scalar loss at ``params``."""
    from fidelityfusion_tpu_torch.utils.tree import tree_leaves, tree_map

    p = tree_map(lambda a: a.detach().clone().requires_grad_(True), params)
    v = fn(p)
    g = torch.autograd.grad(v.sum(), tree_leaves(p))
    return v.detach(), [gi.detach() for gi in g]


def _grad_errs(g, g_ref):
    return [float((a.double() - b.double()).abs().max() / (b.double().abs().max() + 1e-12))
            for a, b in zip(g, g_ref)]


def _check_value_grad(label, v, g, v_ref, g_ref, v_tol, g_tol):
    v, v_ref = float(v), float(v_ref)
    dv = abs(v - v_ref) / max(1.0, abs(v_ref))
    errs = _grad_errs(g, g_ref)
    print(f"{label}: value {v:.6f} reference {v_ref:.6f} ({dv:.2e} of max(1, |v|)); "
          f"gradient leaves' errors {['%.2e' % e for e in errs]}", flush=True)
    check(dv <= v_tol, f"{label}: value within {v_tol:g} of max(1, |v|) ({dv:.2e})")
    check(max(errs) <= g_tol, f"{label}: every gradient leaf within {g_tol:g} ({max(errs):.2e})")


def _shard_fixture(torch, n, d_in, seed, device):
    """`tests/test_nsharded.py`'s data: x in [0, 4)^d, y = sin(sum x) +
    0.1 noise, from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = (rng.random((n, d_in)) * 4).astype(np.float32)
    y = (np.sin(x.sum(1, keepdims=True)) + 0.1 * rng.standard_normal((n, 1))).astype(np.float32)
    return torch.as_tensor(x, device=device), torch.as_tensor(y, device=device)


def _hogp1024_data(torch, device, seed=0):
    """hogp1024's inputs (`bench.py:_hogp_setup`'s shape, phases 5 and 11): n =
    1024, output (32, 32, 32), from a numpy seed."""
    import numpy as np

    n, shape = 1024, (32, 32, 32)
    rng = np.random.default_rng(seed)
    x = rng.random((n, 4)).astype(np.float32)
    base = np.sin(2 * np.pi * x.sum(axis=1)).astype(np.float32)
    y = base.reshape((n, 1, 1, 1)) * rng.random(shape).astype(np.float32)
    return torch.as_tensor(x, device=device), torch.as_tensor(y, device=device), shape


def nll64_plain(torch, gp, p, x, y):
    """A CIGP's NLML in float64 by plain PyTorch (`Kernel.dense`, the CIGP
    noise floor and jitter, `torch.linalg.cholesky` and a triangular
    solve), differentiable: the reference of the 4-rank runs."""
    from fidelityfusion_tpu_torch.ops.linalg import LOG2PI

    K = gp.kernel.dense(p["kernel"], x.double(), x.double())
    noise = gp.noise(p, K.diagonal().mean())
    Sigma = K + (noise + gp.jitter) * torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
    L = torch.linalg.cholesky(Sigma)
    y64 = y.double().reshape(K.shape[0], -1)
    gamma = torch.linalg.solve_triangular(L, y64, upper=False)
    return (0.5 * (gamma * gamma).sum() + y64.shape[1] * torch.log(L.diagonal()).sum()
            + 0.5 * y64.numel() * LOG2PI)


def sharding_one_rank(torch, device, iters, report):
    """Phase 11(a): world size 1 over NCCL (the JAX package's one-chip
    mode), each run against the unsharded path in this call."""
    import numpy as np
    import torch.distributed as dist

    from fidelityfusion_tpu_torch.models.ar import _CigpNLL, train_AR
    from fidelityfusion_tpu_torch.models.cigp import CIGP
    from fidelityfusion_tpu_torch.models.gar import GAR, train_GAR
    from fidelityfusion_tpu_torch.models.hogp import HOGP
    from fidelityfusion_tpu_torch.ops.kernels import ARDKernel, SquaredExponentialKernel
    from fidelityfusion_tpu_torch.parallel import (
        cigp_nll_nsharded, cigp_posterior_nsharded, fit_hogp_nsharded, fit_nsharded,
        fit_restarts_nsharded, hogp_nll_tracked_nsharded, make_n_mesh, make_rn_mesh)
    from fidelityfusion_tpu_torch.train.fit import (
        adam_scan, gp_restart_batch, restart_scores, stack_params)

    out = report["sharding"]["1 rank"] = {}
    mesh = make_n_mesh(device=device)
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"phase 11(a): a world of {dist.get_world_size()} over {dist.get_backend()} "
          "(1 over nccl expected)")

    # cigp_nll_nsharded at n = 2048, ARD d_in = 2, against the unsharded CIGP.nll
    n = 2048
    x, y = _shard_fixture(torch, n, 2, 0, device)
    gp = CIGP(kernel=ARDKernel(), se_analytic_nll=False, hybrid_nll=False)
    p = gp.init_params(2, device=device)
    label = "sharded NLML+grad n=2048 (1 rank)"
    (v, g), _, _ = sharded_run(torch, label, lambda: _value_grad(
        torch, lambda q: cigp_nll_nsharded(gp, q, x, y, mesh), p), CIGP_KERNELS, report)
    v_ref, g_ref = _value_grad(torch, lambda q: gp.nll(q, x, y), p)
    _check_value_grad(label + " vs unsharded CIGP.nll", v, g, v_ref, g_ref, 1e-3, 2e-3)

    # fit_nsharded, 20 steps, beside the unsharded adam_scan
    label = "fit_nsharded n=2048 20 steps (1 rank)"
    (good, losses), sec, _ = sharded_run(
        torch, label, lambda: fit_nsharded(gp, p, x, y, mesh, steps=20, lr=5e-2), CIGP_KERNELS,
        report)
    _, sec_u, _ = _timed_run(torch, lambda: adam_scan(lambda q: gp.nll(q, x, y), p, 5e-2, 20))
    losses = losses.cpu()
    check(bool(torch.isfinite(losses).all()) and losses[-1] < losses[0],
          f"{label}: losses finite and falling ({float(losses[0]):.4f} -> "
          f"{float(losses[-1]):.4f})")
    print(f"{label}: {sec / 20 * 1e3:.2f} ms/step sharded, {sec_u / 20 * 1e3:.2f} ms/step "
          "unsharded (adam_scan over CIGP.nll)", flush=True)
    out["fit_nsharded"] = dict(ms_per_step=sec / 20 * 1e3, unsharded_ms_per_step=sec_u / 20 * 1e3)

    # cigp_posterior_nsharded on 256 test rows against predict_diag
    xt = _shard_fixture(torch, 256, 2, 1, device)[0]
    label = "sharded posterior n=2048, 256 test rows (1 rank)"
    (m, var), sec, _ = sharded_run(
        torch, label, lambda: cigp_posterior_nsharded(gp, p, x, y, xt, mesh),
        ("gram", "chol", "tri_inv"), report)
    with torch.no_grad():
        m_ref, var_ref = gp.predict_diag(p, x, y, xt)
    dm_ = (m - m_ref).abs().max().item()
    ok_v = bool(((var - var_ref).abs() <= 2e-5 + 2e-3 * var_ref.abs()).all())
    print(f"{label}: max |dmean| {dm_:.2e}, max |dvar| {(var - var_ref).abs().max().item():.2e}; "
          f"{sec * 1e3:.2f} ms", flush=True)
    check(dm_ <= 2e-4 + 2e-3 * m_ref.abs().max().item() and ok_v,
          f"{label}: mean atol 2e-4, variance rtol 2e-3 / atol 2e-5 against predict_diag")

    # fit_restarts_nsharded, R = 4 on a (1, 1) mesh: K3a at (4, 2048)
    rn = make_rn_mesh(1, 1, device=device)
    batch = stack_params(gp_restart_batch(gp.kernel, p, x, 4))
    label = "fit_restarts_nsharded R=4 n=2048 20 steps (1x1 mesh)"
    (best, final), sec, counts = sharded_run(
        torch, label, lambda: fit_restarts_nsharded(gp, batch, x, y, rn, steps=20, lr=5e-2,
                                                    r_axis="r"),
        ("gram", "chol_batched", "tri_inv"), report)
    blocked = _CigpNLL(CIGP(kernel=ARDKernel(), blocked_nll=True))
    _, sec_u, _ = _timed_run(torch, lambda: adam_scan(blocked, batch, 5e-2, 20, loss_args=(x, y)))
    final = final.cpu()
    with torch.no_grad():
        v_best = float(gp.nll(best, x, y))
    check(bool(torch.isfinite(final).all())
          and abs(v_best - float(final.min())) <= 1e-2 * max(1.0, abs(v_best)),
          f"{label}: finals finite {np.round(final.numpy(), 4).tolist()}, the winner's "
          f"unsharded NLML {v_best:.4f} within 1e-2 of the best")
    print(f"{label}: {sec / 21 * 1e3:.2f} ms/step sharded (20 steps and the final evaluation), "
          f"{sec_u / 20 * 1e3:.2f} ms/step unsharded (the restart batch through K3a/K3b)",
          flush=True)
    out["fit_restarts_nsharded"] = dict(ms_per_step=sec / 21 * 1e3,
                                        unsharded_ms_per_step=sec_u / 20 * 1e3)

    # train_AR on the main path's data with stage 0 (1024 rows) sharded
    model, dm, x_test, y_test = main_path_setup(device)
    label = "train_AR n_mesh (stage 0 sharded, 1 rank)"
    clock = StageClock(torch)
    (hists, (mean, _)), _, counts = sharded_run(torch, label, lambda: (
        train_AR(model, dm, max_iter=iters, lr_init=5e-2, n_restarts=4, n_mesh=mesh,
                 nshard_min_rows=1024, debugger=clock),
        model.forward(dm, x_test)), CIGP_KERNELS, report)
    mean = mean.detach()
    rmse = float(np.sqrt(np.mean((mean.cpu().numpy() - y_test) ** 2)))
    stage_nll = [float(h.min()) if h.ndim == 1 else float(restart_scores(h).min())
                 for h in hists]
    ms = [s / iters * 1e3 for s in clock.seconds]
    ms_u = [s / iters * 1e3 for s in report["stage_seconds"]]
    print(f"{label}: stage NLMLs {np.round(stage_nll, 4).tolist()} (unsharded main path "
          f"{np.round(report['main_stage_nll'], 4).tolist()}); ms/step {np.round(ms, 2).tolist()} "
          f"(unsharded {np.round(ms_u, 2).tolist()}); test RMSE {rmse:.5f}; launches {counts}",
          flush=True)
    check(hists[0].ndim == 1, f"{label}: stage 0 trained sharded (per-restart finals returned)")
    check(rmse < 0.12, f"{label}: test RMSE {rmse:.5f} < 0.12")
    out["train_AR"] = dict(stage_nll=stage_nll, unsharded_stage_nll=report["main_stage_nll"],
                           ms_per_step=ms, unsharded_ms_per_step=ms_u, rmse=rmse)

    # train_GAR on phase 5's Poisson fields with stage 0 (1024 rows) sharded
    dm, shapes, x_test, truth = field_setup(device)
    model = GAR(3, [ARDKernel() for _ in range(3)], shapes, input_dim=4, device=device)
    label = "train_GAR n_mesh (stage 0 sharded, 1 rank)"
    clock = StageClock(torch)
    (_, (mean, var)), sec, counts = sharded_run(torch, label, lambda: (
        train_GAR(model, dm, max_iter=iters, lr_init=5e-2, n_restarts=4, n_mesh=mesh,
                  nshard_min_rows=1024, debugger=clock),
        model.forward(dm, x_test)), ("gram",), report)
    _, rel = field_metrics(label, mean.detach(), truth)
    ms = [s / iters * 1e3 for s in clock.seconds]
    ms_u = [s["ms_per_step"] for s in report["kron"]["GAR"]["stages"]]
    print(f"{label}: ms/step {np.round(ms, 2).tolist()} (unsharded {np.round(ms_u, 2).tolist()})",
          flush=True)
    out["train_GAR"] = dict(ms_per_step=ms, unsharded_ms_per_step=ms_u, rel_err=rel)

    # fit_hogp_nsharded at hogp1024's shape, 30 steps
    x, y, shape = _hogp1024_data(torch, device)
    hogp = HOGP(kernel=SquaredExponentialKernel(), output_shape=shape)
    p0 = hogp.init_params(4, device=device)
    aux0 = hogp.tracking_aux0(1024, device=device)
    label = "fit_hogp_nsharded hogp1024 30 steps (1 rank)"
    v_sh, g_sh = _value_grad(torch, lambda q: hogp_nll_tracked_nsharded(
        hogp, q, aux0, 0, x, y, mesh, refresh_every=31)[0], p0)
    v_un, g_un = _value_grad(torch, lambda q: hogp.nll_tracked(
        q, aux0, 0, x, y, refresh_every=31)[0], p0)
    _check_value_grad(f"{label}: step 0 vs nll_tracked", v_sh, g_sh, v_un, g_un, 2e-4, 5e-3)
    v_sh, v_un = float(v_sh), float(v_un)
    dv = abs(v_sh - v_un) / max(1.0, abs(v_un))
    (good, losses, (_, max_res)), sec, _ = sharded_run(
        torch, label, lambda: fit_hogp_nsharded(hogp, p0, x, y, mesh, steps=30, lr=1e-2),
        ("gram",), report)
    losses = losses.cpu()
    print(f"{label}: step-0 tracked loss sharded {v_sh:.7f} unsharded {v_un:.7f} ({dv:.2e}); "
          f"NLML {float(losses[0]):.6f} -> {float(losses[-1]):.6f}, max_res {float(max_res):.4f}; "
          f"{sec / 30 * 1e3:.2f} ms/step (unsharded tracked step "
          f"{report['kron']['HOGP']['tracked_step_ms']:.2f} ms in phase 5)", flush=True)
    check(bool(torch.isfinite(losses).all()) and losses[-1] < losses[0],
          f"{label}: losses finite and falling")
    out["fit_hogp_nsharded"] = dict(ms_per_step=sec / 30 * 1e3, step0_rel=dv,
                                    unsharded_tracked_step_ms=report["kron"]["HOGP"][
                                        "tracked_step_ms"])


def _mps_note() -> str:
    """The card's compute mode and whether an MPS control daemon's pipe
    exists: cooperative launches need the whole grid resident, which
    several processes get under time-slicing, not under MPS."""
    import os

    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    pipe = os.environ.get("CUDA_MPS_PIPE_DIRECTORY", "/tmp/nvidia-mps")
    mps = os.path.exists(pipe)
    return (f"compute mode {mode or 'unknown'}; MPS pipe {pipe} "
            f"{'present: MPS may be on' if mps else 'absent: the ranks time-slice the card'}")


def sharding_four_ranks(torch, device, report):
    """Phase 11(b): `SHARD_RANKS` ranks on the one card over gloo (host-
    staged collectives), spawned here, so the P > 1 program runs its
    kernels at P > 1 block sizes; each rank's exit code and results are
    checked.  Times are of 4 ranks sharing 1 card, not a scaling figure."""
    import json
    import tempfile

    from fidelityfusion_tpu_torch.parallel.multihost import launch_local_world

    note = _mps_note()
    print(f"4 ranks, 1 card: {note}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ranks = launch_local_world([sys.executable, str(Path(__file__).resolve()),
                                    "--sharding-rank", tmp], SHARD_RANKS, 600,
                                   cwd=str(Path(__file__).resolve().parent))
        res = []
        for r, (code, _, err) in enumerate(ranks):
            ok = code == 0 and (Path(tmp) / f"rank{r}.json").exists()
            check(ok, f"4 ranks, 1 card: rank {r} exited {code}")
            if not ok:
                print(err[-4000:], file=sys.stderr, flush=True)
                return
            res.append(json.loads((Path(tmp) / f"rank{r}.json").read_text()))
    out = report["sharding"]["4 ranks, 1 card"] = {"note": note}
    for name, required, v_tol, g_tol in (
            ("NLML+grad n=4096, b=1024", CIGP_KERNELS, 1e-3, 2e-3),
            ("restarts_nll_nsharded (2x2) n=2048 residual", CIGP_KERNELS, 1e-3, 2e-3),
            ("hogp_nll_tracked_nsharded n=1024 (32,32,32)", ("gram",), 2e-4, 5e-3),
            # float64 throughout: the sharded program against the exact
            # unsharded NLML, per leaf, with nothing left to float32
            ("hogp_nll_tracked_nsharded float64 n=1024 (32,32,32)", ("gram",), 1e-9, 1e-8)):
        label = f"4 ranks, 1 card: {name}"
        counts = {}
        for r, rr in enumerate(res):
            run = rr[name]
            for k in required:
                names = k if isinstance(k, tuple) else (k,)
                check(sum(run["launches"].get(nm, 0) for nm in names) > 0,
                      f"{label}: rank {r} launched {' or '.join(names)}")
            check(not any(run["plain"].values()),
                  f"{label}: rank {r} called the plain versions 0 times ({run['plain']})")
            for k, c in run["launches"].items():
                counts[k] = counts.get(k, 0) + c
        report["launches_by_path"][label] = counts
        r0 = res[0][name]
        values = [rr[name]["value"] for rr in res]
        check(all(v == values[0] for v in values), f"{label}: the same value on every rank")
        f64 = torch.float64  # the float64 run's numbers keep their digits
        v, v_ref = torch.tensor(r0["value"], dtype=f64), torch.tensor(r0["ref_value"], dtype=f64)
        g, g_ref = ([torch.tensor(a, dtype=f64) for a in r0[k]] for k in ("grads", "ref_grads"))
        if v.ndim:  # the restart vector: each restart against its reference
            for i in range(len(v)):
                _check_value_grad(f"{label}, restart {i}", v[i], [a[i] for a in g], v_ref[i],
                                  [a[i] for a in g_ref], v_tol, g_tol)
        else:
            _check_value_grad(label + f" vs {r0['ref']}", v, g, v_ref, g_ref, v_tol, g_tol)
        print(f"{label}: value and gradient in {r0['seconds'] * 1e3:.1f} ms (rank 0); "
              f"launches over the ranks {counts}", flush=True)
        out[name] = dict(ms=r0["seconds"] * 1e3, launches=counts, reference=r0["ref"])
    # both float32 gradients of hogp1024 against float64 (the Gram
    # cotangents are formed in float64, `ops/kron.py:_kron_nlml_bwd`)
    h32, h64 = (res[0]["hogp_nll_tracked_nsharded n=1024 (32,32,32)"],
                res[0]["hogp_nll_tracked_nsharded float64 n=1024 (32,32,32)"])
    g64 = [torch.tensor(a, dtype=torch.float64) for a in h64["ref_grads"]]
    for who, vk, gk in (("sharded", "value", "grads"), ("unsharded", "ref_value", "ref_grads")):
        _check_value_grad(f"4 ranks, 1 card: hogp1024 float32 {who} vs float64", h32[vk],
                          [torch.tensor(a, dtype=torch.float64) for a in h32[gk]],
                          h64["ref_value"], g64, 2e-4, 5e-3)


def sharding_rank_main(out_dir, rank, world_size, port) -> int:
    """One rank of phase 11(b): joins the gloo world on the card, runs the
    three sharded functions (the Kronecker one in float32 and in float64),
    and writes its launches, plain-version calls,
    values, gradients and (rank 0) the references to ``out_dir``."""
    import json

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from fidelityfusion_tpu_torch.models.cigp import CIGP
    from fidelityfusion_tpu_torch.models.hogp import HOGP
    from fidelityfusion_tpu_torch.ops.kernels import ARDKernel, SquaredExponentialKernel
    from fidelityfusion_tpu_torch.ops.kron import kron_nlml
    from fidelityfusion_tpu_torch.parallel import (
        cigp_nll_nsharded, hogp_nll_tracked_nsharded, make_n_mesh, make_rn_mesh,
        restarts_nll_nsharded)
    from fidelityfusion_tpu_torch.parallel.multihost import initialize_distributed
    from fidelityfusion_tpu_torch.train.fit import gp_restart_batch, stack_params
    from fidelityfusion_tpu_torch.utils.tree import tree_map

    device = torch.device("cuda")
    initialize_distributed(f"localhost:{port}", world_size, rank, device=device, backend="gloo")
    mesh, rn = make_n_mesh(device=device), make_rn_mesh(2, device=device)
    gp = CIGP(kernel=ARDKernel(), se_analytic_nll=False, hybrid_nll=False)
    out = {}

    def record(name, fn, ref_name, ref_fn):
        with PlainCalls() as plain:
            (v, g), sec, counts = _timed_run(torch, fn)
        entry = {"value": v.cpu().tolist(), "grads": [a.cpu().tolist() for a in g],
                 "seconds": sec, "launches": counts, "plain": plain.calls, "ref": ref_name}
        if rank == 0:
            vr, gr = ref_fn()
            entry.update(ref_value=vr.cpu().tolist(), ref_grads=[a.cpu().tolist() for a in gr])
        out[name] = entry

    x, y = _shard_fixture(torch, 4096, 2, 2, device)
    p = gp.init_params(2, device=device)
    record("NLML+grad n=4096, b=1024",
           lambda: _value_grad(torch, lambda q: cigp_nll_nsharded(gp, q, x, y, mesh), p),
           "float64 plain torch (torch.linalg.cholesky)", lambda: _value_grad(
               torch, lambda q: nll64_plain(torch, gp, q, x, y), tree_map(lambda a: a.double(), p)))

    x, yl = _shard_fixture(torch, 2048, 2, 3, device)
    yh = 1.3 * yl + 0.1 * torch.sin(3 * x[:, :1])
    batch = {"gp": stack_params(gp_restart_batch(gp.kernel, p, x, 4)),
             "rho": torch.linspace(0.8, 1.2, 4, device=device)}
    shift, scale = 0.05, 1.2

    def restarts_ref():
        vals, grads = [], []
        for i in range(4):
            v, g = _value_grad(torch, lambda q: nll64_plain(
                torch, gp, q["gp"], x, (yh.double() - q["rho"] * yl.double() - shift) / scale),
                tree_map(lambda a: a[i].double(), batch))
            vals.append(v)
            grads.append(g)
        return torch.stack(vals), [torch.stack(gl) for gl in zip(*grads)]

    record("restarts_nll_nsharded (2x2) n=2048 residual",
           lambda: _value_grad(torch, lambda q: restarts_nll_nsharded(
               gp, q, x, None, rn, r_axis="r", residual=(yl, yh, shift, scale)), batch),
           "float64 plain torch, each restart", restarts_ref)

    xh, yh3, shape = _hogp1024_data(torch, device)
    hogp = HOGP(kernel=SquaredExponentialKernel(), output_shape=shape)
    hp = hogp.init_params(4, device=device)
    aux0 = hogp.tracking_aux0(1024, device=device)
    record("hogp_nll_tracked_nsharded n=1024 (32,32,32)",
           lambda: _value_grad(torch, lambda q: hogp_nll_tracked_nsharded(
               hogp, q, aux0, 0, xh, yh3, mesh)[0], hp),
           "the port's unsharded nll_tracked",
           lambda: _value_grad(torch, lambda q: hogp.nll_tracked(q, aux0, 0, xh, yh3)[0], hp))
    f64 = torch.float64
    xh, yh3, hp = xh.to(f64), yh3.to(f64), tree_map(lambda a: a.to(f64), hp)
    aux0 = tree_map(lambda a: a.to(f64), aux0)

    def nll64(q):  # every step of the exact Kronecker NLML in float64
        K0, K_modes = hogp._grams(q, xh)
        return kron_nlml([K0] + K_modes, yh3, hogp.noise(q))

    record("hogp_nll_tracked_nsharded float64 n=1024 (32,32,32)",
           lambda: _value_grad(torch, lambda q: hogp_nll_tracked_nsharded(
               hogp, q, aux0, 0, xh, yh3, mesh)[0], hp),
           "the exact NLML in float64, unsharded", lambda: _value_grad(torch, nll64, hp))
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


def sharding_paths(torch, device, iters, report):
    """Phase 11: (a) world size 1 over NCCL, (b) 4 ranks on the one card."""
    import torch.distributed as dist

    t = time.perf_counter()
    report["sharding"] = {}
    sharding_one_rank(torch, device, iters, report)
    dist.destroy_process_group()  # the world of one (a) started
    sharding_four_ranks(torch, device, report)
    report["sharding"]["seconds"] = time.perf_counter() - t
    print(f"sharding phase: {time.perf_counter() - t:.1f} s", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=200, help="Adam steps per stage")
    parser.add_argument("--sharding-rank", metavar="OUT_DIR",
                        help="run as one rank of phase 11(b) (started by the phase itself)")
    parser.add_argument("--rank", type=int)
    parser.add_argument("--world-size", type=int)
    parser.add_argument("--port", type=int)
    args = parser.parse_args(argv)
    if args.sharding_rank:
        return sharding_rank_main(args.sharding_rank, args.rank, args.world_size, args.port)

    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "fidelityfusion_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout (fidelityfusion_tpu_torch/ missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}  "
          f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}  "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}", flush=True)

    from fidelityfusion_tpu_torch.ops import chol, cuda, gram

    t = time.perf_counter()
    out = cuda.build([gram._LIB, chol._CHOL, chol._TRI], verbose=True)
    print(f"build: {time.perf_counter() - t:.2f} s", flush=True)
    for line in out.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())
    smi = smi_line()
    print(smi, flush=True)

    report = {}
    phases = (
        ("kernels", lambda: (kernel_checks(torch, device, report),
                             kron_timings(torch, device, report),
                             ill_conditioned_checks(torch, device),
                             panel_checks(torch, device, report),
                             nan_pivot_check(torch, device))),
        ("main path", lambda: main_path(torch, device, args.iters, report)),
        ("cascades", lambda: cascade_paths(torch, device, args.iters, report)),
        ("Kronecker", lambda: kron_paths(torch, device, args.iters, report)),
        ("joint and legacy", lambda: joint_legacy_paths(torch, device, args.iters, report)),
        ("unbatched", lambda: unbatched_paths(torch, device)),
        ("BO", lambda: bo_paths(torch, device, report)),
        ("experiments", lambda: experiment_paths(torch, device, report)),
        ("sharding", lambda: sharding_paths(torch, device, args.iters, report)),
        ("profiler", lambda: count_device_ops(torch, device, report)))
    walls = {}
    for name, run in phases:
        t = time.perf_counter()
        run()
        walls[name] = round(time.perf_counter() - t, 1)
    print(f"phase walls (s): {walls}", flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start to the last phase",
          flush=True)

    counts = report["main_counts"]
    kernels = []
    for key, label in (("gram", "K1 gram"), ("chol", "K2 chol"),
                       ("chol_batched", "K3a chol_batched"), ("tri_inv", "K3b tri_inv")):
        k = dict(report[key])
        k.update(name=label, route="cuda", launches=counts.get(key, 0), launches_by_path={
            path: c.get(key, 0) for path, c in report["launches_by_path"].items()})
        kernels.append({f: k.get(f) for f in (
            "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape", "launches_by_path") + tuple(
            f for f in ("timing", "call_ms", "cross_ms", "cross_bound_ms", "cross_plain_ms",
                        "cross_library_ms", "cross_max_abs_err", "d2", "d4", "f64", "bo", "d10",
                        "slab",
                        "leaf_us", "device_ops_per_call", "shapes") if f in k)})
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:", file=sys.stderr)
        for f in FAILURES:
            print("  " + f, file=sys.stderr)
        return 1
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
