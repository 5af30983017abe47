"""Lookups a second: every key answered by a request that completed in the
window, summed over the clients, over the window's seconds."""
import numpy as np


def read(run):
    r = run.requests
    done = r["ok"] & (r["t2"] <= run.t_end)
    return float(np.sum(r["size"][done]) / run.seconds)
