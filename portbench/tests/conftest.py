"""The benchmark's tests run on the CPU at tiny sizes (the drivers through
the kernels' plain versions); those marked ``cuda`` need a card and skip
without one, decided inside the ``cuda_device`` fixture."""

import pytest


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (TF32 and the port's kernels exist only there)")
    return torch.device("cuda", 0)
