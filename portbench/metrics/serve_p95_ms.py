"""The 95th percentile, in milliseconds, of the latency of every request
due in the window, from when it was due to when its future held the
answer; a request never answered counts with its wait until the cut."""
import numpy as np


def read(rec):
    lat = rec.get("latencies_s")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3
