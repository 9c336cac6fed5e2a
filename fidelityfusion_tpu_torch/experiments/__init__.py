from fidelityfusion_tpu_torch.experiments.metrics import (  # noqa: F401
    calculate_metrix,
    gaussian_nll,
    nrmse,
    r2,
    rmse,
)
