from fidelityfusion_tpu_torch.bo.acq import ei, kg, mean_sigma_ratio, pf, pi, ucb  # noqa: F401
from fidelityfusion_tpu_torch.bo.optimize import find_next_batch, optimize_acqf  # noqa: F401
from fidelityfusion_tpu_torch.bo.mf_acq import (  # noqa: F401
    DiscreteMFAcquisition,
    optimize_acq_mf,
)
from fidelityfusion_tpu_torch.bo.continuous import (  # noqa: F401
    ContinuousFidelityES,
    ContinuousFidelityKG,
    ContinuousFidelityUCB,
)
from fidelityfusion_tpu_torch.bo.cfkg import cfkg_select, fantasy_gain  # noqa: F401
from fidelityfusion_tpu_torch.bo.loop import mf_bo_discrete  # noqa: F401
