"""NAR end to end against the JAX package on the CPU: training from the JAX init on the
subset design, and the carried-parameter cascade
(`tests/torch_port_checks.py` says what is checked and to which
tolerance)."""

import pytest

from tests import torch_port_checks as C


@pytest.fixture(scope="module")
def jax_runs():
    return C.jax_runs()


def test_nar_training_from_jax_init_matches_jax(jax_runs):
    C.check_training(jax_runs, "NAR", False)


def test_nar_forward_with_carried_params_matches_jax(jax_runs):
    C.check_forward(jax_runs, "NAR")
