"""scan_roofline: the exact scan's share of its roofline, in %, over the
profiled stretch of requests (torch.profiler): the stretch's requests,
each priced at the least time the card could take for it
(bench/roofline.py `scan_bound_s` at the configuration's rows and the
traffic's batch and k), over the time the device was busy in the
stretch (the union of its kernel, copy and set records). Divided by the
device's busy time and not by named kernels, it reads the same work
whatever implements the scan, and the host's time between requests does
not enter it."""

from bench.roofline import scan_bound_s


def read(run):
    t = run["trace"]
    if not t or not t["requests"] or t["busy_s"] <= 0:
        return None
    cfg, tr = run["config"], run["traffic"]
    bound = scan_bound_s(int(cfg["rows"]), int(cfg["dim"]),
                         int(tr["queries_per_request"]), int(tr["k"]))
    return 100.0 * t["requests"] * bound / t["busy_s"]
