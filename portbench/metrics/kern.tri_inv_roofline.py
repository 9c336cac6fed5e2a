"""K3b (`csrc/tri_inv.cu`) against its roofline, in %: as
`kern.chol_roofline`, with `counts.tri_inv_cost`."""

from portbench import counts


def read(run):
    t = run.traced
    launches = t.launches.get("ff_tri_inv") if t is not None else None
    if not launches:
        return None
    bound = sum(counts.bound_s(*counts.tri_inv_cost(b, n)) for b, n, _ in launches)
    return 100.0 * bound / sum(s for _, _, s in launches)
