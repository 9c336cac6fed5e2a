"""Checks shared by the port's field-model tests against the JAX package
(GAR and CIGAR, subset and non-subset, in tests/test_torch_hogp.py).

GAR and CIGAR on the Poisson fixture of `tests/test_hogp_gar.py:20`
(resolutions (6, 10, 14), 48 samples, d_in = 4, seed 3), two fidelities,
15 Adam steps at lr 5e-2 over 4 restarts, to keep the JAX compiles few:
subset, fidelities 0 and 2 on the first 40 and 24 samples (test rows
40..47); non-subset, the JAX test's design (fidelity 0 on samples 0..39,
fidelity 1 on 8..31 and 44..47, test rows 40..43), through the imputation
path.  The port trains from the JAX model's initial parameters
(`convert.load_state`) and is held to the JAX package on each stage's
final NLML, the chosen restart and `forward`'s means and variances.

Tolerances: a stage's final NLML within 1e-4 of max(|NLML|, 1) for GAR
(element-normalized NLMLs of order 1) and 1e-4 of max(|NLML|, rows) for
CIGAR (summed over D output columns); the chosen restart equal unless the
JAX scores of the two lie within that tolerance; means and variances
within 1e-4 of their largest magnitude (float32, two ``eigh`` or
Cholesky implementations)."""

import jax
import jax.numpy as jnp
import numpy as np

from fidelityfusion_tpu.data.pde import generate_poisson_mf_dataset as j_poisson
from fidelityfusion_tpu.models import cigar as JC
from fidelityfusion_tpu.models import gar as JG
from fidelityfusion_tpu.models.data_manager import MultiFidelityDataManager as JDM
from fidelityfusion_tpu.ops.kernels import ARDKernel as JARD
from fidelityfusion_tpu_torch.convert import load_state
from fidelityfusion_tpu_torch.data.pde import generate_poisson_mf_dataset
from fidelityfusion_tpu_torch.models import cigar as TC
from fidelityfusion_tpu_torch.models import gar as TG
from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager as TDM
from fidelityfusion_tpu_torch.ops.kernels import ARDKernel
from fidelityfusion_tpu_torch.train.fit import restart_scores

ITERS, LR, RESTARTS = 15, 5e-2, 4
MODELS = {"GAR": (JG.GAR, JG.train_GAR, TG.GAR, TG.train_GAR),
          "CIGAR": (JC.CIGAR, JC.train_CIGAR, TC.CIGAR, TC.train_CIGAR)}


def poisson_data(nonsubset, flat):
    """(data-manager entries, per-fidelity output shapes, test x, test y of
    the top fidelity); the port's copy of the generator gives the JAX
    package's fields bit for bit."""
    x, ys = generate_poisson_mf_dataset(n_samples=48, resolutions=(6, 10, 14), d_in=4, seed=3)
    jx, jys = j_poisson(n_samples=48, resolutions=(6, 10, 14), d_in=4, seed=3)
    assert np.array_equal(x, jx) and all(np.array_equal(a, b) for a, b in zip(ys, jys))
    if nonsubset:
        rows = [np.arange(40), np.r_[8:32, 44:48]]
        fids, test = (0, 1), np.arange(40, 44)
    else:
        rows, fids, test = [np.arange(40), np.arange(24)], (0, 2), np.arange(40, 48)
    shapes = [ys[f].shape[1:] for f in fids]
    out = [ys[f].reshape(len(x), -1) if flat else ys[f] for f in fids]
    entries = [{"raw_fidelity_name": str(k), "fidelity_indicator": k, "X": x[r], "Y": out[k][r]}
               for k, r in enumerate(rows)]
    return entries, shapes, x[test], out[1][test]


def jax_run(name, nonsubset):
    """The JAX model trained on the fixture: model, data manager, initial
    parameters, per-stage histories, forward mean and variance."""
    jcls, jtrain, _, _ = MODELS[name]
    entries, shapes, x_test, y_test = poisson_data(nonsubset, flat=name == "CIGAR")
    dm = JDM(entries)
    model = jcls(2, [JARD(), JARD()], shapes, if_nonsubset=nonsubset, input_dim=4)
    init = jax.tree_util.tree_map(np.asarray, model.params)
    hist = jtrain(model, dm, max_iter=ITERS, lr_init=LR, n_restarts=RESTARTS)
    mean, var = jax.jit(lambda xt: model.forward(dm, xt))(jnp.asarray(x_test))
    return {"model": model, "dm": dm, "init": init, "hist": [np.asarray(h) for h in hist],
            "mean": np.asarray(mean), "var": np.asarray(var), "entries": entries,
            "shapes": shapes, "x_test": x_test, "y_test": y_test}


def port_model(name, shapes, nonsubset=False):
    return MODELS[name][2](2, [ARDKernel(), ARDKernel()], shapes, if_nonsubset=nonsubset,
                           input_dim=4, device="cpu")


def check_stages(name, hist, jhist, rows):
    for i, (h, jh) in enumerate(zip(hist, jhist)):
        s, js = restart_scores(h), restart_scores(jh)
        tol = 1e-4 * max(abs(js.min()), rows[i] if name == "CIGAR" else 1.0)
        assert abs(s.min() - js.min()) <= tol, (i, s, js)
        pick, jpick = int(np.argmin(s)), int(np.argmin(js))
        assert pick == jpick or abs(js[pick] - js[jpick]) <= tol, (i, s, js)


def check_close(got, want):
    got = got.detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def check_training(ref, name, nonsubset):
    """The port trained from the JAX init: per-stage final NLML, chosen
    restart, `forward` mean and variance against the JAX run; variances
    positive and the top fidelity's relative error that of the JAX model
    within 1e-3."""
    model = port_model(name, ref["shapes"], nonsubset)
    load_state(model, ref["init"])
    dm = TDM(ref["entries"])
    hist = MODELS[name][3](model, dm, max_iter=ITERS, lr_init=LR, n_restarts=RESTARTS)
    check_stages(name, hist, ref["hist"], [len(e["X"]) for e in ref["entries"]])
    mean, var = model.forward(dm, ref["x_test"])
    check_close(mean, ref["mean"])
    check_close(var, ref["var"])
    assert (var.detach().numpy() > 0).all()
    rel = lambda m: np.linalg.norm(m - ref["y_test"]) / np.linalg.norm(ref["y_test"])  # noqa
    assert abs(rel(mean.detach().numpy()) - rel(ref["mean"])) < 1e-3


def carried_data_manager(ref):
    """A port data manager holding the JAX run's data and its stage
    datasets (the ``res-i`` residuals that training registered)."""
    dm = TDM(ref["entries"])
    for key, entry in ref["dm"].data_dict.items():
        if entry["fidelity_index"] is None:
            dm.add_data(key, None, entry["X"], entry["Y"])
    return dm
