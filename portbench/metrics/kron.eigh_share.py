"""The eigensolver's share of the device's busy time in the traced GAR
fit, in %: the device time of the cuSOLVER kernels that `eigh_seconds`
matches by name (`torch.linalg.eigh`'s `syevd` on every K_0 refresh, every
mode Gram and every posterior state: `sytrd4_*` and its `syr2k` updates,
the divide and conquer's `laed*`, `steqr_ker`, `merge_ker`, the
back-transformation's `ormqr`/`larft`, and the small `lacpy`, `lansy`,
`lascl`, `scale_max` passes), over the trace's busy time.  The GEMMs that
cuSOLVER calls inside the solver carry cuBLAS's names, which the program's
own GEMMs share, and are not counted."""

import re

EIGH_KERNELS = re.compile(r"sytrd|syr2k|laed|steqr|stedc|merge_ker|ormqr|ormtr|larft|lacpy"
                          r"|lansy|setup_vhat|scale_max|lascl|cuds_scal|copy_info_kernel"
                          r"|xx_set_info")


def eigh_seconds(op_seconds) -> float:
    return sum(s for name, s in op_seconds.items() if EIGH_KERNELS.search(name))


def read(run):
    t = run.traced
    if t is None or t.busy_s <= 0:
        return None
    eigh = eigh_seconds(t.op_seconds)
    return 100.0 * eigh / t.busy_s if eigh > 0 else None
