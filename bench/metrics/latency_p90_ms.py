"""latency_p90_ms: the 90th percentile of every request of the window,
each timed from the moment it is sent until its ids and distances are
on the host. The percentile is the linear interpolation between order
statistics (numpy's default)."""

import numpy as np


def read(run):
    lat = run["window"]["latencies_s"]
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 90.0)) * 1e3
