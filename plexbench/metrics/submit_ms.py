"""The mean host milliseconds a request spends inside ``submit`` (staging,
per-shard routing, dispatch), from the harness's own clock around the
call, over every request of the window."""
import numpy as np


def read(run):
    r = run.requests
    if not r.size:
        return None
    return float(np.mean(r["t1"] - r["t0"]) * 1e3)
