"""The 95th percentile, over all the window's requests, of the time from
submitting a request to its features being on the host."""
import numpy as np


def read(run):
    lat = [c["latency_s"] for c in run.get("calls", []) if "latency_s" in c]
    if not lat:
        return None
    return 1e3 * float(np.percentile(lat, 95))
