"""The median query latency of the window, in ms (host clock, a query
ending with its result on the host): a steadier statistic beside the
tail, not a decider."""

import numpy as np


def read(run):
    if not run.records:
        return None
    return 1e3 * float(np.median([r["lat"] for r in run.records]))
