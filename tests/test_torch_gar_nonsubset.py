"""GAR end to end against the JAX package on the CPU, non-subset design:
training from the JAX init through the imputation path (the cascade's own
`forward` fills the missing low-fidelity fields; their variance enters
K_0's diagonal), exact ``eigh`` every step
(`tests/torch_field_checks.py` says what is checked and to which
tolerance)."""

import pytest

from tests import torch_field_checks as C


@pytest.fixture(scope="module")
def ref():
    return C.jax_run("GAR", True)


def test_gar_nonsubset_training_from_jax_init_matches_jax(ref):
    C.check_training(ref, "GAR", True)
