from fidelityfusion_tpu_torch.data.pde import (  # noqa: F401
    generate_poisson_mf_dataset,
    heat_fields,
    poisson_fields,
)
