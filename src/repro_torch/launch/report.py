"""Render the dry-run and roofline tables from a sweep JSONL of the port's
records (the reference's `launch/report.py`).

The port's records carry no compiler fields (`launch/dryrun.py`): the
compile, resident and collectives columns print "-", and the fit is
judged on the arguments a device holds against the card's memory
(`launch/roofline.py HW`).

  PYTHONPATH=src python -m repro_torch.launch.report d.jsonl
"""

from __future__ import annotations

import json
import sys

from repro_torch.launch.roofline import HW


def _fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b/1e9:.2f}GB"


def _fmt_s(x):
    if x is None:
        return "-"
    if x >= 0.1:
        return f"{x:.2f}s"
    if x >= 1e-4:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.1f}us"


def load(path):
    recs = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line in ("DONE", "ALLDONE"):
                continue
            r = json.loads(line)
            arch = r["arch"].replace("-", "_").replace(".", "")
            r["arch"] = arch
            key = (arch, r["shape"], r["mesh"], r.get("variant", ""))
            recs[key] = r  # last write wins
    return recs


def dryrun_table(recs):
    rows = ["| arch | shape | mesh | status | compile | arguments/dev "
            "| resident/dev | fits | collectives present |",
            "|---|---|---|---|---|---|---|---|---|"]
    for (a, s, m, var), r in sorted(recs.items()):
        if var:
            continue
        mem = r.get("mem") or {}
        coll = r.get("collectives_hlo_raw") or {}
        kinds = ",".join(sorted(k for k in coll if k != "total" and coll[k] > 0))
        status = r["status"] if r["status"] != "skipped" else "skip"
        compile_s = r.get("compile_s")
        rows.append(
            f"| {a} | {s} | {m} | {status} "
            f"| {'-' if compile_s is None else f'{compile_s}s'} "
            f"| {_fmt_bytes(mem.get('argument_bytes'))} "
            f"| {_fmt_bytes(mem.get('resident_bytes'))} "
            f"| {mem.get('fits_hbm', '-')} | {kinds or '-'} |")
    return "\n".join(rows)


def roofline_table(recs, mesh="single"):
    rows = ["| arch | shape | compute | memory | collective | dominant | "
            "MODEL_FLOPs/analytic | note |",
            "|---|---|---|---|---|---|---|---|"]
    for (a, s, m, var), r in sorted(recs.items()):
        if var:
            continue
        if m != mesh or r["status"] != "ok":
            continue
        note = _bottleneck_note(r)
        rows.append(
            f"| {a} | {s} | {_fmt_s(r.get('compute_s'))} "
            f"| {_fmt_s(r.get('memory_s'))} | {_fmt_s(r.get('collective_s'))} "
            f"| **{r.get('dominant', '-').replace('_s', '')}** "
            f"| {r.get('useful_flops_ratio', 0):.2f} | {note} |")
    return "\n".join(rows)


def _bottleneck_note(r) -> str:
    dom = r.get("dominant")
    if dom == "compute_s":
        ratio = r.get("useful_flops_ratio", 0)
        if ratio < 0.55:
            return "masked attn blocks / remat waste: skip fully-masked KV blocks"
        return "near peak: fuse or quantize to move further"
    if dom == "memory_s":
        return "weight/KV streaming bound: quantize KV or batch more queries"
    return "shard or overlap collectives; compress cross-pod grads"


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    path = args[0] if args else "experiments/dryrun_all.jsonl"
    recs = load(path)
    n_ok = sum(1 for r in recs.values() if r["status"] == "ok")
    n_skip = sum(1 for r in recs.values() if r["status"] == "skipped")
    n_err = sum(1 for r in recs.values() if r["status"] == "error")
    fits = sum(1 for r in recs.values()
               if r.get("mem", {}).get("fits_hbm") is True)
    print(f"## Dry-run summary: {n_ok} ok / {n_skip} skipped / {n_err} error; "
          f"{fits}/{n_ok} fit {HW().hbm_bytes / 1e9:.0f}GB HBM "
          f"(arguments only)\n")
    print(dryrun_table(recs))
    print("\n## Roofline (single-pod 16x16, per device, per step)\n")
    print(roofline_table(recs, "single"))
    print("\n## Roofline (multi-pod 2x16x16)\n")
    print(roofline_table(recs, "multi"))


if __name__ == "__main__":
    main()
