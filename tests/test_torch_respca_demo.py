"""The port's ResPCA family against the JAX package on a seeded field,
and the port's demo for each model it has, on the CPU."""

import numpy as np
import pytest

from fidelityfusion_tpu.models import respca as JP
from fidelityfusion_tpu_torch.models import respca as TP


def _fields(rng, n, d1, d2, rank=3):
    return (rng.standard_normal((n, rank)) @ rng.standard_normal((rank, d1 * d2))).reshape(
        n, d1, d2)


def _close_up_to_sign(got, want, rtol):
    """Columns of ``got`` equal to ``want``'s up to each column's sign."""
    got, want = np.asarray(got), np.asarray(want)
    sign = np.sign((got * want).sum(0))
    np.testing.assert_allclose(got * sign, want, rtol=rtol, atol=rtol * np.abs(want).max())


def test_respca_family_matches_jax():
    """PCA, ListPCA, ResPCA and ResPCAMF on seeded fields: equal ranks,
    projections rtol 1e-5 up to the sign of each basis vector,
    recoveries rtol 1e-5."""
    rng = np.random.default_rng(0)
    y = _fields(rng, 30, 6, 5)
    jp, tp = JP.PCA(y, energy=0.999), TP.PCA(y, energy=0.999, device="cpu")
    assert tp.rank == jp.rank
    _close_up_to_sign(tp.project(y), jp.project(y), 1e-5)
    z = tp.project(y)
    np.testing.assert_allclose(tp.recover(z).numpy(), np.asarray(jp.recover(jp.project(y))),
                               rtol=1e-5, atol=1e-5)
    assert TP.PCA(y, rank=2, device="cpu").rank == 2

    ys = [_fields(rng, 25, 4, 4), _fields(rng, 25, 6, 6)]
    jl, tl = JP.ListPCA(ys, energy=0.999), TP.ListPCA(ys, energy=0.999, device="cpu")
    for g, w in zip(tl.project(ys), jl.project(ys)):
        _close_up_to_sign(g, w, 1e-5)
    for g, w in zip(tl.recover(tl.project(ys)), jl.recover(jl.project(ys))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)

    base = _fields(rng, 30, 5, 5)
    ys = [base, base + 0.1 * _fields(rng, 30, 5, 5)]
    jr, tr = JP.ResPCA(ys, energy=0.999), TP.ResPCA(ys, energy=0.999, device="cpu")
    assert [p.rank for p in tr.res_pcas] == [p.rank for p in jr.res_pcas]
    for g, w in zip(tr.project(ys), jr.project(ys)):
        _close_up_to_sign(g, w, 1e-5)
    for g, w in zip(tr.recover(tr.project(ys)), jr.recover(jr.project(ys))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)

    ys = [_fields(rng, 30, 4, 4), _fields(rng, 20, 4, 4), _fields(rng, 12, 4, 4)]
    jm, tm = JP.ResPCAMF(ys, energy=0.99), TP.ResPCAMF(ys, energy=0.99, device="cpu")
    got, want = tm.project_residuals(ys), jm.project_residuals(ys)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        _close_up_to_sign(g, w, 1e-5)


@pytest.mark.parametrize("model,nonsubset", [
    ("NAR", False), ("NAR", True), ("ResGP", False), ("ResGP", True), ("CAR", False),
    ("CAR_large", False), ("CIGP", False), ("FIDES", False)])
def test_demo_runs_each_model_on_cpu(model, nonsubset):
    from fidelityfusion_tpu_torch import demo

    argv = [model, "--device", "cpu", "--iters", "5", "--restarts", "2"]
    m = demo.main(argv + (["--nonsubset"] if nonsubset else []))
    assert np.isfinite(list(m.values())).all() and m["rmse"] < 1.0


def test_demo_refuses_nonsubset_for_other_models():
    from fidelityfusion_tpu_torch import demo

    with pytest.raises(SystemExit):
        demo.main(["CAR", "--device", "cpu", "--nonsubset"])
