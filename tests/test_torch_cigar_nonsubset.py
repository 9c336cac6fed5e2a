"""CIGAR end to end against the JAX package on the CPU, non-subset design,
through the imputation path (`tests/torch_field_checks.py` says what is
checked and to which tolerance)."""

import pytest

from tests import torch_field_checks as C


@pytest.fixture(scope="module")
def ref():
    return C.jax_run("CIGAR", True)


def test_cigar_nonsubset_training_from_jax_init_matches_jax(ref):
    C.check_training(ref, "CIGAR", True)
