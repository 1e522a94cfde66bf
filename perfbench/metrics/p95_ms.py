"""The 95th percentile of the latency, from the client's call until the
answer is on the host, of every query answered in the window."""
import numpy as np


def read(run):
    lat = [r.latency_ms for r in run.done()]
    return float(np.percentile(lat, 95)) if lat else None
