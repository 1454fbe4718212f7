"""Reduction of torch.profiler traces of stretches of requests.

A traced run profiles two stretches of requests once its window has
closed. The first records the device alone (CUDA activity: kernels,
copies, sets, and the runtime calls that launch them), which slows the
host little: its busy time is the length of the union of the device records, so
overlapping records count once, over the stretch's length on the host
clock. The second also records the host's torch ops, inside a
`record_function` range named `RANGE` a request, and names the idle
gaps: each stretch between the first range's start and the last range's
end in which no device record runs is named by the innermost host op
open at its midpoint (a CUDA runtime call is named with the op that
launched it), or "host, between ops" where none is open. Recording the
host's ops slows the host, so the second stretch's gaps are longer than
the first's; what it gives is their split by cause.
"""

from __future__ import annotations

__all__ = ["RANGE", "device_busy", "idle_gaps"]

RANGE = "bench.request"
_TOP = 10


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _split(events):
    """(request ranges, host ops, device records) as (start, end, name)
    in microseconds."""
    from torch.autograd import DeviceType

    ranges, cpu, dev = [], [], []
    for e in events:
        rec = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == DeviceType.CPU:
            (ranges if e.name == RANGE else cpu).append(rec)
        elif e.device_type == DeviceType.CUDA and e.name != RANGE:
            dev.append(rec)
    return ranges, cpu, dev


def _top(d: dict) -> list:
    return sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:_TOP]


def device_busy(events) -> dict | None:
    """{busy_s, device_s (name -> s), device_ops (the ten names with the
    most time)} over every device record, or None when there is none."""
    _, _, dev = _split(events)
    if not dev:
        return None
    by_name: dict = {}
    for s, t, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (t - s) / 1e6
    busy = _merge([(s, t) for s, t, _ in dev])
    return {"busy_s": sum(b - a for a, b in busy) / 1e6,
            "device_s": by_name, "device_ops": _top(by_name)}


def _host_names(cpu, points):
    """The innermost host op open at each of the sorted `points` (us)."""
    cpu = sorted(cpu, key=lambda e: (e[0], -e[1]))
    names, stack, i = [], [], 0
    for m in points:
        while i < len(cpu) and cpu[i][0] <= m:
            s, e, name = cpu[i]
            while stack and stack[-1][1] < s:
                stack.pop()
            stack.append((s, e, name))
            i += 1
        open_ = [x for x in stack if x[1] >= m]
        if not open_:
            names.append("host, between ops")
        elif open_[-1][2].startswith("cuda") and len(open_) > 1:
            names.append(f"{open_[-2][2]} > {open_[-1][2]}")
        else:
            names.append(open_[-1][2])
    return names


def idle_gaps(events) -> list:
    """The ten causes with the most idle seconds, [[name, seconds], ...],
    over the window the request ranges span."""
    ranges, cpu, dev = _split(events)
    if not ranges:
        return []
    t0 = min(r[0] for r in ranges)
    t1 = max(r[1] for r in ranges)
    busy = _merge([(max(s, t0), min(t, t1)) for s, t, _ in dev
                   if t > t0 and s < t1])
    edges = [t0] + [x for b in busy for x in b] + [t1]
    gaps = [(edges[j], edges[j + 1]) for j in range(0, len(edges), 2)
            if edges[j + 1] > edges[j]]
    by_gap: dict = {}
    for (a, b), n in zip(gaps, _host_names(cpu, [(a + b) / 2
                                                 for a, b in gaps])):
        by_gap[n] = by_gap.get(n, 0.0) + (b - a) / 1e6
    return _top(by_gap)
