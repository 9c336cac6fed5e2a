"""Neither the harness nor the reference loads JAX or the JAX package
(top-level names compared whole), and the reference loads nothing of the
port."""

import ast
import json
import subprocess
import sys

import pytest

from portbench import harness

PKG = harness.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "fidelityfusion_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=harness.ROOT, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(harness.ROOT)})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_no_program():
    mods = _loaded("import portbench.reference.cigp, portbench.data.zoo, portbench.counts")
    assert not mods & (FORBIDDEN | {"fidelityfusion_tpu_torch"})


def test_harness_and_drivers_load_no_jax():
    code = ("from portbench import harness, trace, control\n"
            "for d in ('fit_ar', 'query_ar'):\n"
            "    harness.driver(d)\n"
            "import fidelityfusion_tpu_torch.models.ar\n"
            "for m in harness.manifest()['per_layer']:\n"
            "    harness.metric_reader(m['name'])\n")
    mods = _loaded(code)
    assert "fidelityfusion_tpu_torch" in mods
    assert not mods & FORBIDDEN


@pytest.mark.parametrize("path", sorted(p.relative_to(PKG).as_posix()
                                        for p in PKG.rglob("*.py") if "tests" not in p.parts))
def test_no_source_imports_jax(path):
    tree = ast.parse((PKG / path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & FORBIDDEN
    if path.startswith(("reference/", "data/")) or path == "counts.py":
        assert "fidelityfusion_tpu_torch" not in names


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "fidelityfusion_tpu_torch_x", object())
    assert "fidelityfusion_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax.numpy" in harness.forbidden_modules()


def test_run_refuses_without_cuda():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "ar.fit-p4-4096",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=harness.ROOT, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
