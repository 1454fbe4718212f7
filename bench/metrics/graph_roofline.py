"""graph_roofline: the graph search's share of its roofline, in %, over
the profiled stretch of requests (torch.profiler): the stretch's queries,
each priced at the least time the card could take for the rows its
distance evaluations read (bench/roofline_graph.py `graph_bound_s` at the
run's `dist_calcs_per_query` and the configuration's row width), over the
time the device was busy in the stretch (the union of its kernel, copy
and set records). Divided by the device's busy time, it reads the same
work whatever implements the search, and the host's time between
requests does not enter it."""

from bench.roofline_graph import graph_bound_s


def read(run):
    t, c = run["trace"], run["counters"]
    if not t or not t["queries"] or t["busy_s"] <= 0:
        return None
    if not c["queries"] or not c["dist_calcs"]:
        return None
    cfg = run["config"]
    bound = graph_bound_s(t["queries"], c["dist_calcs"] / c["queries"],
                          int(cfg["dim"]), cfg.get("dtype", "float32"))
    return 100.0 * bound / t["busy_s"]
