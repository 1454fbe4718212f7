"""Recompute the analytic roofline terms of existing dry-run records (the
reference's `launch/reterm.py`), in place.

The placement-level fields (specs, argument and alias bytes) do not
depend on the cost model, so only the analytic terms need refreshing
after a cost-model change: `launch/dryrun.py analytic_terms` over each
record's config, variant and device count, with the reference's model
axis of 16 (the production meshes'). Rewrites the JSONL in place.

  PYTHONPATH=src python -m repro_torch.launch.reterm d.jsonl
"""

from __future__ import annotations

import json
import sys

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import (analytic_terms, apply_variant,
                                       serve_fsdp_rule)


def refresh(rec: dict) -> dict:
    if rec.get("status") != "ok":
        return rec
    cfg, state_mode = apply_variant(get_config(rec["arch"]),
                                    rec.get("variant", ""))
    rec.update(analytic_terms(
        cfg, SHAPES[rec["shape"]], rec["devices"], 16,
        serve_fsdp_rule(rec["params_total"]), rec["params_active"],
        state_mode))
    return rec


def main(argv=None) -> None:
    for path in (sys.argv[1:] if argv is None else argv):
        recs = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line == "ALLDONE":
                    continue
                recs.append(refresh(json.loads(line)))
        with open(path, "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
        print(f"refreshed {len(recs)} records in {path}")


if __name__ == "__main__":
    main()
