"""recall_at_10: the share of the exact top-10 found, over every query
the window served (compare.judge's miss_share, taken from 1)."""


def read(run):
    n = run["numbers"]
    if not n["queries"]:
        return None
    return 1.0 - n["miss_share"]
