"""dist_calcs_per_query: the graph search's distance evaluations a query
(the program's `QueryStats.dist_calcs`, the upper layers' and layer 0's,
summed over the partitions), over every request the run asked statistics
of: the window's and the profiled stretches'."""


def read(run):
    c = run["counters"]
    if not c["queries"] or not c["dist_calcs"]:
        return None
    return c["dist_calcs"] / c["queries"]
