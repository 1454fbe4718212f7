#!/usr/bin/env python3
"""Readings behind the bf16 gates of `chip_smoke.py`'s lm phase: checks (c)
and (d) on several model seeds, and the same checks with a fault put in,
which the gates must refuse.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/torch_lm_gates.py [--seeds 0,1,2,3,4,5,6,7] \\
        [--out chiprun_out/lm_gates.json]

For each seed it draws deepseek-v2-lite-16b at full width and depth in
bf16 from `torch.Generator("cuda").manual_seed(seed)`, then B=8 prompts of
T=2,048 tokens, as the lm phase does (seed 0 is the phase's own model and
prompts), and reads (c) prefill(256) + decode x3 against prefill(259) and
(d) the 8 x 2,048 prefill with the plain topk and flash_attention against
the kernels, both with the capacity raised so that no token is dropped
(`chip_smoke.lm_bf16_pairs`). The controls run the same two checks with a
fault:
  * `noncausal`: the flash kernel without its causal mask, in (c) and in
    place of the plain versions in (d);
  * `early`: (c) with each decode step one position early (its rope
    angle and cache slot).
Each reading is printed with whether `chip_smoke.bf16_gate` passes it
under chip_smoke's LM_TOL_BF16 and LM_GREEDY_SHARE, then, for each fault
and check over the seeds, the range of max |d| / max |logit|, of RMS |d|
/ RMS |logit| and of the greedy share, and how many readings passed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def early_decode():
    """Every decode_step one position early (lm_invariant imports it from
    the model module when it runs)."""
    from repro_torch.models import model as M

    saved = M.decode_step
    M.decode_step = lambda model, tokens, cache, pos, cfg: saved(
        model, tokens, cache, pos - 1, cfg)
    try:
        yield
    finally:
        M.decode_step = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0,1,2,3,4,5,6,7")
    ap.add_argument("--out", default="chiprun_out/lm_gates.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_lm_gates.py: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flash = ops.flash_attention

    def noncausal(q, k, v, *, causal=True):
        return flash(q, k, v, causal=False)

    cfg = cs.lm_config()
    V = cfg.vocab_size
    readings = []
    for seed in (int(s) for s in args.seeds.split(",")):
        g = torch.Generator(device=cs.DEVICE).manual_seed(seed)
        model = init_params(cfg, device=cs.DEVICE, generator=g)
        prompts = torch.randint(0, V, (cs.LM_B, cs.LM_T), generator=g,
                                device=cs.DEVICE)
        runs = [("none", cs.lm_bf16_pairs(model, cfg, prompts)),
                ("noncausal", cs.lm_bf16_pairs(model, cfg, prompts,
                                               flash_fn=noncausal))]
        with early_decode():
            runs.append(("early", {"(c)": cs.lm_invariant(
                model, cs.no_drop_config(cfg),
                prompts[:2, :cs.LM_C_T + 3])}))
        for fault, checks in runs:
            for what, pairs in checks.items():
                gap = cs.logit_gap(pairs, V)
                r = {"seed": seed, "fault": fault, "check": what[:3],
                     "ratio": gap["err"] / gap["scale"], "rms": gap["rms"],
                     "same": gap["same"], "n": gap["n"],
                     "flips": gap["flips"], "passes": cs.bf16_gate(gap)}
                readings.append(r)
                print(json.dumps(r), flush=True)
        del model, prompts, runs
        torch.cuda.empty_cache()

    summary = {"LM_TOL_BF16": cs.LM_TOL_BF16,
               "LM_GREEDY_SHARE": cs.LM_GREEDY_SHARE}
    for fault in ("none", "noncausal", "early"):
        for check in ("(c)", "(d)"):
            rs = [r for r in readings
                  if r["fault"] == fault and r["check"] == check]
            if rs:
                summary[f"{fault} {check}"] = {
                    "max_ratio": max(r["ratio"] for r in rs),
                    "min_ratio": min(r["ratio"] for r in rs),
                    "max_rms": max(r["rms"] for r in rs),
                    "min_rms": min(r["rms"] for r in rs),
                    "min_share": min(r["same"] / r["n"] for r in rs),
                    "max_share": max(r["same"] / r["n"] for r in rs),
                    "passed": sum(r["passes"] for r in rs), "of": len(rs)}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"readings": readings, "summary": summary},
                              indent=1))
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
