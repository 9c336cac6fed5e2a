"""K2/K3a (`ops/chol.py` -> `csrc/chol.cu`) against its roofline, in %:
each traced launch's bound time (the larger of its FLOPs over 67 TFLOP/s
and its bytes over 3.35 TB/s, from its (B, n); `counts.chol_cost`)
summed, over those launches' device time in the trace."""

from portbench import counts


def read(run):
    t = run.traced
    launches = t.launches.get("ff_chol_inv") if t is not None else None
    if not launches:
        return None
    bound = sum(counts.bound_s(*counts.chol_cost(b, n)) for b, n, _ in launches)
    return 100.0 * bound / sum(s for _, _, s in launches)
