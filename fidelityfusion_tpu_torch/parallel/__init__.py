"""The sharding layer over `torch.distributed` (port of
`fidelityfusion_tpu/parallel/`): the mesh helpers, the n-axis sharded
Gram/Cholesky NLML and posterior, restarts x n, and the sharded
Kronecker/HOGP path."""

from fidelityfusion_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    shard_leading_axis,
    sharded_acq_argmax,
    sharded_fit_restarts,
    sharded_posterior_mean,
)
from fidelityfusion_tpu_torch.parallel.nsharded import (  # noqa: F401
    cigp_nll_nsharded,
    cigp_posterior_nsharded,
    fit_nsharded,
    fit_restarts_nsharded,
    make_n_mesh,
    make_rn_mesh,
    restarts_nll_nsharded,
)
from fidelityfusion_tpu_torch.parallel.kron_nsharded import (  # noqa: F401
    fit_hogp_nsharded,
    hogp_nll_tracked_nsharded,
)
