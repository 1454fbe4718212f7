"""device_idle_share: 1 - (the union of the device's kernel, copy and set
intervals / the traced window) over the profiled stretch of requests at
the start of the window (torch.profiler)."""


def read(run):
    t = run["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
