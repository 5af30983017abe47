"""The 95th percentile of a request's milliseconds from ``submit`` to its
result, over every answered request of the window (those that came after
its close too)."""
import numpy as np


def read(run):
    r = run.requests[run.requests["ok"]]
    if not r.size:
        return None
    return float(np.percentile((r["t2"] - r["t0"]) * 1e3, 95))
