"""CIGAR end to end against the JAX package on the CPU, subset design:
training from the JAX init (each stage's restart batch of 40 and 24 rows
through the fused NLML), and the JAX-trained parameters carried across
with `convert.load_state` (`tests/torch_field_checks.py` says what is
checked and to which tolerance)."""

import pytest

from fidelityfusion_tpu_torch.convert import load_state
from tests import torch_field_checks as C


@pytest.fixture(scope="module")
def ref():
    return C.jax_run("CIGAR", False)


def test_cigar_training_from_jax_init_matches_jax(ref):
    C.check_training(ref, "CIGAR", False)


def test_cigar_forward_with_carried_params_matches_jax(ref):
    jm = ref["model"]
    model = C.port_model("CIGAR", ref["shapes"])
    dm = C.carried_data_manager(ref)
    load_state(model, C.jax.tree_util.tree_map(C.np.asarray, jm.params), jm.stage_norm)
    mean, var = model.forward(dm, ref["x_test"])
    C.check_close(mean, ref["mean"])
    C.check_close(var, ref["var"])
