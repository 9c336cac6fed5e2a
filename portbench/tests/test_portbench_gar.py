"""The GAR cell's benchmark files against the benchmark's rules: its
reference, data and counts load nothing of the port, its driver and faults
load no JAX, and every per-layer reader gives None on a run that has
nothing for it to read (an older program, or a cell that does not run
the reader's layer), so the result line leaves the metric out."""

import ast
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.tests.test_portbench_imports import FORBIDDEN, PKG, _loaded

BENCH = harness.manifest()


def test_gar_reference_loads_no_program():
    mods = _loaded("import portbench.reference.gar, portbench.data.poisson, portbench.counts_gar")
    assert not mods & (FORBIDDEN | {"fidelityfusion_tpu_torch"})


def test_gar_driver_and_faults_load_no_jax():
    code = ("from portbench import harness, kron_faults\n"
            "harness.driver('fit_gar')\n"
            "import fidelityfusion_tpu_torch.models.gar\n")
    mods = _loaded(code)
    assert "fidelityfusion_tpu_torch" in mods
    assert not mods & FORBIDDEN


@pytest.mark.parametrize("path", ["counts_gar.py", "reference/gar.py", "data/poisson.py"])
def test_gar_counts_and_reference_import_no_program(path):
    tree = ast.parse((PKG / path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & (FORBIDDEN | {"fidelityfusion_tpu_torch"})


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_reader_reads_nothing_from_a_run_with_nothing_to_read(metric):
    empty = SimpleNamespace(records=[], window_s=0.0, traced=None, traffic={"steps": 1})
    assert harness.metric_reader(metric["name"]).read(empty) is None
