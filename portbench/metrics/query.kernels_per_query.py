"""Device kernels per query in the traced segment (copies and sets not
counted): the host launch path's work per query."""


def read(run):
    t = run.traced
    if t is None or not t.units or t.n_kernels == 0:
        return None
    return t.n_kernels / t.units
