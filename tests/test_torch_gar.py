"""GAR end to end against the JAX package on the CPU, subset design, both
stages through the tracked-spectrum NLML (the row threshold patched down
to 8 in both packages, as `tests/test_spectral.py:310` does): training
from the JAX init, and the JAX-trained parameters carried across with
`convert.load_state`, whose stage states the port rebuilds
(`tests/torch_field_checks.py` says what is checked and to which
tolerance)."""

import pytest

from fidelityfusion_tpu.models import gar as JG
from fidelityfusion_tpu_torch.convert import load_state
from fidelityfusion_tpu_torch.models import gar as TG
from tests import torch_field_checks as C


@pytest.fixture(scope="module")
def ref():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JG, "_TRACK_N_THRESHOLD", 8)
        mp.setattr(TG, "_TRACK_N_THRESHOLD", 8)
        yield C.jax_run("GAR", False)


def test_gar_tracked_training_from_jax_init_matches_jax(ref):
    C.check_training(ref, "GAR", False)


def test_gar_forward_with_carried_params_matches_jax(ref):
    jm = ref["model"]
    model = C.port_model("GAR", ref["shapes"])
    dm = C.carried_data_manager(ref)
    load_state(model, C.jax.tree_util.tree_map(C.np.asarray, jm.params), jm.stage_norm,
               data_manager=dm)
    mean, var = model.forward(dm, ref["x_test"])
    C.check_close(mean, ref["mean"])
    C.check_close(var, ref["var"])
    low, low_var = model.forward(dm, ref["x_test"], to_fidelity=0)
    assert low.shape == (len(ref["x_test"]),) + ref["shapes"][0] and (low_var > 0).all()
