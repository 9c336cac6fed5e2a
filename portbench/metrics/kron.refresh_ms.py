"""Device milliseconds of the eigensolver's tridiagonal reduction per
tracked-spectrum refresh in the traced GAR fit: the time of the `syevd`
reduction kernels whose template names a refreshed size (`sytrd4_gpu`,
`transpose`, `epilogue` of ``sytrd_params<double, _, _, n, ...>``, n a size
that the program's counter, `ops/spectral.py:spectral_counts`, saw
refreshed in that fit), over the refreshes counted.  The mode Grams'
decompositions (8 to 32 rows) are left out; the divide and conquer and
back-transformation kernels name no size and are left out too.  At those
sizes the reduction also runs for each stage's posterior state, one
matrix against the refreshes' nine (two batches of four restarts and the
winner's check).  None where the program has no such counter."""

import re

REDUCTION = re.compile(r"sytrd_params<double, \d+, \d+, (\d+),")


def reduction_seconds(op_seconds, sizes) -> float:
    total = 0.0
    for name, s in op_seconds.items():
        m = REDUCTION.search(name)
        if m and int(m.group(1)) in sizes:
            total += s
    return total


def read(run):
    t, fit = run.traced, getattr(run, "traced_fit", None)
    if t is None or not fit or not fit.get("spectral"):
        return None
    counted = fit["spectral"]["refresh"]
    refreshes = sum(counted.values())
    seconds = reduction_seconds(t.op_seconds, set(counted))
    if refreshes == 0 or seconds <= 0:
        return None
    return 1e3 * seconds / refreshes
