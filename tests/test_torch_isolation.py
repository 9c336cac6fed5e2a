"""The port and its chip scripts stand alone: they import neither JAX nor
the JAX package, and the port's entry points never move a run to the CPU
on their own."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "fidelityfusion_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_torch_ar.py",
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
    from fidelityfusion_tpu_torch.models.fides import FIDES
    from fidelityfusion_tpu_torch.models.nar import NAR
    from fidelityfusion_tpu_torch.models.resgp import ResGP
    from fidelityfusion_tpu_torch.models.respca import PCA
    from fidelityfusion_tpu_torch.ops.kernels import (
        ARDKernel, MCFidelityKernel, SquaredExponentialKernel)

    se, ard = SquaredExponentialKernel(), ARDKernel()
    for make in (lambda: AR(3, [se] * 3), lambda: ResGP(3, [se] * 3), lambda: NAR(3, [se] * 3),
                 lambda: ContinuousAutoRegression(3, [ard] * 3),
                 lambda: ContinuousAutoRegressionLarge(3, ard),
                 lambda: CIGP(se).init_params(1), lambda: GPBasic(ard).init_params(1),
                 lambda: GPBasic(MCFidelityKernel(base=ard)).init_params(1),
                 lambda: FIDES().init_params(1), lambda: PCA(np.ones((4, 3)))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    for model in ("AR", "NAR", "ResGP", "CAR", "CAR_large", "CIGP", "FIDES"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            demo.main([model, "--iters", "1"])


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
