"""qps: every query completed in the window over the window's seconds."""


def read(run):
    w = run["window"]
    if not w["queries"] or w["seconds"] <= 0:
        return None
    return w["queries"] / w["seconds"]
