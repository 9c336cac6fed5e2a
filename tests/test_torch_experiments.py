"""The port's data zoo and experiment harness (`fidelityfusion_tpu_torch/
data/zoo.py`, `experiments/load_mfdata.py`, `experiments/sweep.py`,
`experiments/plots.py`, `utils/plotting.py`, the examples) against the
JAX package on the CPU.

Tolerances:
- the zoo and `load_data`: equal arrays, bit for bit (the same numpy
  code);
- `run_single` from the same data (n_low 32, n_high 8, n_test 32, 30
  steps, 4 restarts): rmse and nrmse rtol 1e-3, r2 atol 1e-3, nll within
  1e-2 of max(|nll|, 1).  AR, ResGP, NAR, GAR and CIGAR train from their
  deterministic inits; staged CAR draws its MC fidelity points from torch
  generators, so it starts from the JAX model's initial parameters
  (`convert.load_state`), and trains at `train_CAR`'s lr 1e-2: at the
  grid's 5e-2 its stage-0 restarts part from the JAX ones at step 6 (by
  0.09 to 0.87 of an NLML near -55 after 30 steps; ROADMAP Queue 3);
- the sweep protocols: the CSVs' headers and row counts equal the JAX
  harness's;
- the plots' aggregation: equal dictionaries on the same files.
"""

import csv

import jax
import numpy as np
import pytest

from fidelityfusion_tpu.data import zoo as JZ
from fidelityfusion_tpu.experiments import load_mfdata as JL
from fidelityfusion_tpu.experiments import plots as JP
from fidelityfusion_tpu.experiments import sweep as JS
from fidelityfusion_tpu_torch.convert import load_state
from fidelityfusion_tpu_torch.data import zoo as TZ
from fidelityfusion_tpu_torch.experiments import load_mfdata as TL
from fidelityfusion_tpu_torch.experiments import plots as TP
from fidelityfusion_tpu_torch.experiments import sweep as TS

ZOO_NAMES = sorted(JZ.ZOO)


def _equal_outputs(a, b):
    (xa, ya), (xb, yb) = a, b
    return (np.array_equal(xa, xb) and len(ya) == len(yb)
            and all(np.array_equal(u, v) for u, v in zip(ya, yb)))


@pytest.mark.parametrize("name", ZOO_NAMES)
def test_zoo_function_matches_jax_bit_for_bit(name):
    """Each of the 41 functions: the registry entry, sampled inputs at a
    seed, and user-given inputs (drawn from a numpy seed over the
    function's own sampled range)."""
    jfn, d, nf = JZ.ZOO[name]
    tfn, td, tnf = TZ.ZOO[name]
    assert (td, tnf, tfn.__name__) == (d, nf, jfn.__name__)
    assert _equal_outputs(jfn(num_points=17, seed=3), tfn(num_points=17, seed=3))
    assert _equal_outputs(jfn(), tfn())
    x = jfn(num_points=64, seed=5)[0]
    rng = np.random.default_rng(11)
    given = x.min(0) + rng.random((9, d)) * (x.max(0) - x.min(0))
    out = tfn(x=given)
    assert _equal_outputs(jfn(x=given), out) and len(out[1]) == nf


def test_zoo_registry_matches_jax():
    assert list(TZ.ZOO) == list(JZ.ZOO) and len(TZ.ZOO) == 41


DATASETS = ["forrester12", "forrester34", "colville12", "toal12", "p123", "tl112",
            "maolin1012", "test912"]


@pytest.mark.parametrize("dataset", DATASETS)
def test_load_data_and_names_match_jax(dataset):
    """`parse_name`, subset and non-subset `load_data` (bit for bit), and
    `all_fidelity_pairs` of the family."""
    assert TL.parse_name(dataset) == JL.parse_name(dataset)
    base = JL.parse_name(dataset)[0]
    assert TL.all_fidelity_pairs(base) == JL.all_fidelity_pairs(base)
    for subset in (True, False):
        kw = dict(n_train_low=24, n_train_high=7, n_test=11, seed=2, subset=subset)
        j, t = JL.load_data(dataset, **kw), TL.load_data(dataset, **kw)
        assert set(j) == set(t) and j["x_dim"] == t["x_dim"]
        for k in ("x_low", "y_low", "x_high", "y_high", "x_test", "y_test"):
            assert t[k].dtype == j[k].dtype and np.array_equal(t[k], j[k]), (k, subset)


def test_parse_name_errors_match_jax():
    for bad, err in (("forrester", ValueError), ("nosuch12", KeyError)):
        with pytest.raises(err):
            JL.parse_name(bad)
        with pytest.raises(err):
            TL.parse_name(bad)


RUN_KW = dict(n_low=32, n_test=32, max_iter=30, n_restarts=4)


@pytest.mark.parametrize("method", ["AR", "ResGP", "NAR", "CAR", "GAR", "CIGAR"])
def test_run_single_matches_jax(method, monkeypatch):
    """One grid cell on forrester12 (the JAX test's GAR/CIGAR scalar case
    among them: output shape (1,)) on ``device="cpu"``."""
    kw = dict(RUN_KW)
    if method == "CAR":
        kw["lr"] = 1e-2
        init = {}
        j_build, t_build = JS._build_model, TS._build_model

        def jax_build(*a, **k):
            model, train = j_build(*a, **k)
            init["params"] = jax.tree_util.tree_map(np.asarray, model.params)
            return model, train

        def port_build(*a, **k):
            model, train = t_build(*a, **k)
            load_state(model, init["params"])
            return model, train

        monkeypatch.setattr(JS, "_build_model", jax_build)
        monkeypatch.setattr(TS, "_build_model", port_build)
    j = JS.run_single(method, "forrester12", 0, 8, **kw)
    t = TS.run_single(method, "forrester12", 0, 8, device="cpu", **kw)
    assert set(t) == set(j) and np.isfinite(list(t.values())).all()
    np.testing.assert_allclose([t["rmse"], t["nrmse"]], [j["rmse"], j["nrmse"]], rtol=1e-3)
    assert abs(t["r2"] - j["r2"]) <= 1e-3, (t, j)
    assert abs(t["nll"] - j["nll"]) <= 1e-2 * max(abs(j["nll"]), 1.0), (t, j)


def _csvs(root):
    """{relative path: (header, row count)} of every CSV under root."""
    out = {}
    for p in sorted(root.rglob("*.csv")):
        with open(p, newline="") as f:
            rows = list(csv.reader(f))
        out[str(p.relative_to(root))] = (rows[0], len(rows) - 1)
    return out


PROTOCOLS = {
    "grid": lambda pkg, root, kw: pkg.run_sweep(
        ["ResGP"], ["tl112"], seeds=[0], n_high_grid=[6, 10], outdir=root, n_low=24,
        n_test=20, **kw),
    "car": lambda pkg, root, kw: pkg.run_car_sweep(
        seeds=(0,), train_sizes=(16,), outdir=root, **kw),
    "gar-field": lambda pkg, root, kw: pkg.run_gar_field_sweep(
        methods=("CIGAR",), seeds=(0,), n_high_grid=(6,), n_low=16, n_test=8,
        resolutions=(4, 6), outdir=root, **kw),
}


@pytest.mark.parametrize("protocol", list(PROTOCOLS))
def test_sweep_protocol_writes_the_jax_csvs(protocol, tmp_path):
    """`run_sweep` (ResGP, two n_high), `run_car_sweep` (one train size)
    and `run_gar_field_sweep` (CIGAR, non-aligned, one n_high), 10 steps
    and 2 restarts a stage, write the files of the JAX harness: the same
    paths, headers and row counts."""
    for pkg, root in ((JS, tmp_path / "jax"), (TS, tmp_path / "port")):
        kw = dict(max_iter=10, n_restarts=2, **({} if pkg is JS else {"device": "cpu"}))
        PROTOCOLS[protocol](pkg, str(root), kw)
    port = _csvs(tmp_path / "port")
    assert port == _csvs(tmp_path / "jax") and len(port) == 1
    header, n_rows = next(iter(port.values()))
    assert header == ["train_sample_num", "rmse", "nrmse", "r2", "nll", "time"]
    assert n_rows == (2 if protocol == "grid" else 1)


def test_car_cost_sweep_writes_the_reference_csv(tmp_path):
    """`run_car_cost_sweep` (two cells) writes the cost protocol's columns
    (`sweep.py:run_car_cost_sweep` of the JAX package), a row per cell."""
    rows = TS.run_car_cost_sweep(start_seeds=(1,), n_cells=2, outdir=str(tmp_path),
                                 max_iter=10, n_restarts=2, device="cpu")
    files = _csvs(tmp_path)
    assert len(rows) == 2 and files == {
        "sample_data/car_seed_1.csv": (["cost", "rmse", "r2", "nll", "nrmse", "time"], 2)}


def test_sweep_cli_on_cpu(tmp_path):
    """`main --device cpu` runs a grid cell and writes its CSV."""
    rows = TS.main(["--methods", "AR", "--datasets", "forrester12", "--seeds", "0",
                    "--n-high", "6", "--n-low", "20", "--n-test", "10", "--max-iter", "10",
                    "--outdir", str(tmp_path), "--device", "cpu"])
    assert len(rows) == 1 and (tmp_path / "forrester12" / "AR_seed_0.csv").exists()


@pytest.mark.parametrize("dataset", ["forrester12", "tl112"])
def test_plots_aggregation_matches_jax(dataset):
    """`load_sweep_results` and `aggregate_metric` of the port on the
    repo's recorded grid CSVs (`exp_results/grid/`) equal JAX's."""
    from pathlib import Path

    outdir = str(Path(__file__).resolve().parents[1] / "exp_results" / "grid")
    j, t = JP.load_sweep_results(outdir, dataset), TP.load_sweep_results(outdir, dataset)
    assert t == j and len(t) >= 3
    for metric in ("rmse", "nll"):
        ja, ta = JP.aggregate_metric(j, metric), TP.aggregate_metric(t, metric)
        assert set(ta) == set(ja)
        for m in ja:
            assert all(np.array_equal(a, b) for a, b in zip(ta[m], ja[m]))


def test_plots_save_with_agg(tmp_path):
    """One figure of each module, saved through matplotlib's Agg backend."""
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    from pathlib import Path

    from fidelityfusion_tpu_torch.utils import plotting

    outdir = str(Path(__file__).resolve().parents[1] / "exp_results" / "grid")
    TP.plot_metric_vs_nhigh(outdir, "forrester12", save_to=str(tmp_path / "rmse.png"))
    x = np.linspace(0, 1, 20)
    ax = plotting.plot_1d_posterior(x, np.sin(x), 0.01 * np.ones(20), y_true=np.sin(x))
    ax.figure.savefig(tmp_path / "post.png")
    assert (tmp_path / "rmse.png").stat().st_size > 0 and (tmp_path / "post.png").stat().st_size > 0


def test_example_01_runs_on_cpu():
    """Example 01 (AR, ResGP, NAR on the 3-fidelity toy) on ``--device
    cpu``, cut to 30 steps a stage: finite metrics, AR's RMSE < 0.1."""
    from fidelityfusion_tpu_torch.examples import ex01_multifidelity_regression as ex01

    out = ex01.main(["--device", "cpu", "--iters", "30"])
    assert set(out) == {"AR", "ResGP", "NAR"}
    assert all(np.isfinite(list(m.values())).all() for m in out.values())
    assert out["AR"]["rmse"] < 0.1
