"""The port and its chip scripts stand alone: they import neither JAX nor
the JAX package, and the port's entry points never move a run to the CPU
on their own."""

import ast
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "fidelityfusion_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_torch_ar.py",
    ROOT / "scripts" / "profile_torch_gar.py", ROOT / "scripts" / "time_gar_eigh_routes.py",
    ROOT / "scripts" / "time_torch_kernels.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            roots.update(a.value.split(".")[0] for a in node.args[:1]
                         if isinstance(a, ast.Constant) and isinstance(a.value, str))
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_no_jax(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "optax", "fidelityfusion_tpu", "benchmarks"}, roots


NEW_MODULES = ("models.joint", "models.legacy", "utils.config", "utils.logging",
               "utils.profiling", "utils.checkpoint", "ops.kernels", "models.cigp", "convert",
               "data.cost", "data.objectives", "bo", "bo.acq", "bo.optimize", "bo.mf_acq",
               "bo.cfkg", "bo.strategies", "bo.mace", "bo.continuous", "bo.loop",
               "bo.continuous_loop", "data", "data.zoo", "data.real_app", "experiments",
               "experiments.load_mfdata", "experiments.sweep", "experiments.plots",
               "utils.plotting", "examples.ex01_multifidelity_regression",
               "examples.ex02_mfbo_discrete", "examples.ex03_gar_fields",
               "examples.ex04_mfbo_continuous", "parallel", "parallel.collectives",
               "parallel.mesh", "parallel.nsharded", "parallel.kron_nsharded",
               "parallel.multihost", "experiments.sharded_sweep",
               "examples.ex05_large_n_scaling")


def test_port_module_imports_pull_in_no_jax():
    """Each module of the joint/legacy, BO, experiments and sharding slices,
    imported one after the other in a fresh interpreter, loads neither JAX
    nor anything of the JAX package (checked after every import, so a
    failure names its module)."""
    code = ("import importlib, json, sys\n"
            "bad = {}\n"
            f"for m in {NEW_MODULES!r}:\n"
            "    importlib.import_module('fidelityfusion_tpu_torch.' + m)\n"
            "    bad[m] = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'fidelityfusion_tpu'))\n"
            "print(json.dumps(bad))\n")
    # below the suite's per-test time limit (the root conftest.py), so a hang
    # shows this call's own timeout
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=240, check=True)
    bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(bad) == set(NEW_MODULES) and not any(bad.values()), bad


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device: the default device is valid here")


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from fidelityfusion_tpu_torch import demo
    from fidelityfusion_tpu_torch.models.ar import AR
    from fidelityfusion_tpu_torch.models.car import (
        ContinuousAutoRegression, ContinuousAutoRegressionLarge)
    from fidelityfusion_tpu_torch.models.cigp import CIGP, GPBasic
    from fidelityfusion_tpu_torch.models import two_fidelity as two
    from fidelityfusion_tpu_torch.models.cigar import CIGAR
    from fidelityfusion_tpu_torch.models.coupling import TensorLinear
    from fidelityfusion_tpu_torch.models.fides import FIDES
    from fidelityfusion_tpu_torch.models.gar import GAR
    from fidelityfusion_tpu_torch.models.hogp import HOGP
    from fidelityfusion_tpu_torch.models.legacy import LegacyCIGP, LegacyFIDES, LegacyHOGP
    from fidelityfusion_tpu_torch.models.nar import NAR
    from fidelityfusion_tpu_torch.models.resgp import ResGP
    from fidelityfusion_tpu_torch.models.respca import PCA
    from fidelityfusion_tpu_torch.ops import kernels as TK
    from fidelityfusion_tpu_torch.ops.kernels import (
        ARDKernel, MCFidelityKernel, SquaredExponentialKernel)

    se, ard = SquaredExponentialKernel(), ARDKernel()
    for make in (lambda: AR(3, [se] * 3), lambda: ResGP(3, [se] * 3), lambda: NAR(3, [se] * 3),
                 lambda: ContinuousAutoRegression(3, [ard] * 3),
                 lambda: ContinuousAutoRegressionLarge(3, ard),
                 lambda: CIGP(se).init_params(1), lambda: GPBasic(ard).init_params(1),
                 lambda: GPBasic(MCFidelityKernel(base=ard)).init_params(1),
                 lambda: FIDES().init_params(1), lambda: PCA(np.ones((4, 3))),
                 lambda: HOGP(ard, (4, 3)).init_params(4),
                 lambda: HOGP(ard, (4, 3)).tracking_aux0(8),
                 lambda: HOGP(ard, (4, 3)).tracking_aux0_adaptive(8),
                 lambda: TensorLinear((3,), (5,)).init_params(),
                 lambda: GAR(2, [ard] * 2, [(3, 3), (5, 5)]),
                 lambda: CIGAR(2, [ard] * 2, [(3, 3), (5, 5)]),
                 lambda: two.ARTwoFidelity(), lambda: two.NARTwoFidelity(),
                 lambda: two.ResGPTwoFidelity(), lambda: two.GARTwoFidelity((3, 3), (5, 5)),
                 LegacyCIGP, LegacyHOGP, LegacyFIDES,
                 lambda: CIGP(TK.SumKernel(ard, TK.LinearKernel()), x64_factor=True).init_params(1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    for model in ("AR", "NAR", "ResGP", "CAR", "CAR_large", "CIGP", "FIDES", "GAR", "HOGP",
                  "CIGAR"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            demo.main([model, "--iters", "1"])


def test_experiment_entry_points_default_to_cuda_and_raise_without_it(no_cuda, tmp_path):
    """The harness, the objectives, `CIGPWithMean` and the examples: each
    raises before any work when no device is named."""
    from fidelityfusion_tpu_torch.data import real_app
    from fidelityfusion_tpu_torch.examples import (
        ex01_multifidelity_regression, ex02_mfbo_discrete, ex03_gar_fields,
        ex04_mfbo_continuous)
    from fidelityfusion_tpu_torch.experiments import sweep
    from fidelityfusion_tpu_torch.models.cigp import CIGPWithMean
    from fidelityfusion_tpu_torch.ops.kernels import ARDKernel

    out = str(tmp_path)
    makes = [lambda: sweep.run_single("AR", "forrester12", 0, 8),
             lambda: sweep.run_sweep(["AR"], ["forrester12"], seeds=[0], outdir=out),
             lambda: sweep.run_car_sweep(outdir=out),
             lambda: sweep.run_car_cost_sweep(outdir=out),
             lambda: sweep.run_gar_field_sweep(outdir=out),
             lambda: sweep.main(["--methods", "AR", "--outdir", out]),
             lambda: sweep.main(["--protocol", "gar-field", "--outdir", out]),
             lambda: real_app.MLPTrainingObjective(2), lambda: real_app.CNNTrainingObjective(2),
             lambda: CIGPWithMean(ARDKernel()).init_params(1)]
    makes += [lambda m=m: m.main([]) for m in (
        ex01_multifidelity_regression, ex02_mfbo_discrete, ex03_gar_fields,
        ex04_mfbo_continuous)]
    if importlib.util.find_spec("sklearn") is not None:
        makes += [real_app.DigitsMLPObjective, real_app.DigitsCNNObjective]
    for make in makes:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert not list(tmp_path.iterdir())


def test_sharding_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    """The mesh builders, `initialize_distributed`, the sharded sweep, the
    scaling harness and example 05 raise before they start a process group
    when no device is named."""
    import torch.distributed as dist

    from fidelityfusion_tpu_torch.examples import ex05_large_n_scaling
    from fidelityfusion_tpu_torch.experiments.sharded_sweep import run_sharded_seed_sweep
    from fidelityfusion_tpu_torch.parallel import make_mesh, make_n_mesh, make_rn_mesh
    from fidelityfusion_tpu_torch.parallel.multihost import (
        initialize_distributed, restart_scaling_efficiency)

    for make in (make_mesh, make_n_mesh, lambda: make_rn_mesh(1), initialize_distributed,
                 lambda: initialize_distributed("localhost:1", 4, 0),
                 lambda: run_sharded_seed_sweep("forrester12", [0]), restart_scaling_efficiency,
                 lambda: ex05_large_n_scaling.main([])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        assert not dist.is_initialized()


def test_chip_smoke_refuses_without_a_card(no_cuda, capsys):
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_demo_runs_on_cpu_when_asked():
    from fidelityfusion_tpu_torch import demo

    m = demo.main(["AR", "--device", "cpu", "--iters", "30", "--restarts", "2"])
    assert np.isfinite(list(m.values())).all() and m["rmse"] < 0.2


@pytest.mark.parametrize("model", ["HOGP", "GAR", "CIGAR"])
def test_field_demo_runs_on_cpu_when_asked(model):
    """The field models' demo on 64 Poisson fields, cut to 20 steps and two
    restarts: finite metrics, r2 above 0.5 on the held-out fields."""
    from fidelityfusion_tpu_torch import demo

    m = demo.main([model, "--device", "cpu", "--iters", "20", "--restarts", "2"])
    assert np.isfinite(list(m.values())).all() and m["r2"] > 0.5
