"""descent_kernel_ms_per_kq: the device time of the upper-layer descent
kernel (every device record whose name holds "descent") over the profiled
stretch of requests (torch.profiler), in ms per 1,000 queries served in
it. A program without that kernel reads None."""


def read(run):
    t = run["trace"]
    if not t or not t["queries"]:
        return None
    s = sum(v for name, v in t["device_s"].items() if "descent" in name)
    if s <= 0:
        return None
    return 1e6 * s / t["queries"]
