#!/usr/bin/env python3
"""Readings behind the bf16 gates of `chip_smoke.py`'s lm phase: checks (c)
and (d) on several model seeds, and the same checks with a fault put in,
which the gates must refuse.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/torch_lm_gates.py [--arch deepseek_v2_lite_16b] \\
        [--seeds 0,1,2,3,4,5,6,7] [--out chiprun_out/lm_gates.json]

For each seed it draws `--arch` at full width and depth in bf16 from
`torch.Generator("cuda").manual_seed(seed)`, then its prompts as
chip_smoke.py does, and reads its checks (c) and (d):
  * deepseek-v2-lite-16b (the lm phase; seed 0 is the phase's own model
    and prompts): B=8 prompts of T=2,048 tokens, (c) prefill(256) +
    decode x3 against prefill(259) and (d) the 8 x 2,048 prefill with the
    plain topk and flash_attention against the kernels, both with the
    capacity raised so that no token is dropped
    (`chip_smoke.lm_bf16_pairs`);
  * qwen3-14b (the dense phase's main path; seed 0 is its model and
    prompts): the same B and T, (c) prefill(256) + decode x3, (d) the 8 x
    2,048 prefill with the plain flash_attention
    (`chip_smoke.dense_bf16_pairs`);
  * h2o-danube3-4b: B=2 prompts of 8,195 tokens, (c) prefill(8,192) +
    decode x3 across its 4,096 window, (d) the 2 x 8,192 prefill.
The controls run the same two checks with a fault:
  * `noncausal`: the flash kernel without its causal mask, in (c) and in
    place of the plain versions in (d);
  * `early`: (c) with each decode step one position early (its rope
    angle and cache slot);
  * `kvmod` (GQA): query head h reads KV head h % KV in place of h // G,
    in (c) and (d);
  * `wide` (a window): the flash kernel's window one key too wide, in (c)
    and (d).
Each reading is printed with whether `chip_smoke.bf16_gate` passes it
under the architecture's gate (chip_smoke's BF16_GATES), then, for each
fault and check over the seeds, the range of max |d| / max |logit|, of
RMS |d| / RMS |logit| and of the greedy share, and how many readings
passed.
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
    ap.add_argument("--arch", default="deepseek_v2_lite_16b",
                    choices=("deepseek_v2_lite_16b", "qwen3_14b",
                             "h2o_danube3_4b"))
    ap.add_argument("--seeds", default="0,1,2,3,4,5,6,7")
    ap.add_argument("--out", default=None,
                    help="default chiprun_out/lm_gates.json, and "
                         "chiprun_out/lm_gates_<arch>.json for the others")
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

    def noncausal(q, k, v, **kw):
        return flash(q, k, v, **dict(kw, causal=False))

    def wide(q, k, v, **kw):
        return flash(q, k, v, **dict(kw, window=kw["window"] + 1))

    def kvmod(q, k, v, **kw):
        """Query head h on KV head h % KV: the heads reordered so that the
        kernel's h // G mapping lands there, and back."""
        heads, kvh = cfg.n_heads, cfg.n_kv_heads
        b, t, hd = q.shape[0] // heads, q.shape[1], q.shape[2]
        qp = q.view(b, heads // kvh, kvh, t, hd).transpose(1, 2)
        out = flash(qp.reshape(b * heads, t, hd), k, v, **kw)
        return out.view(b, kvh, heads // kvh, t, hd).transpose(1, 2).reshape(
            b * heads, t, hd)

    dense = args.arch != cs.LM_ARCH
    if dense:
        cfg = cs.dense_config(args.arch)
        swa = cfg.pattern[0].window > 0
        b, n = (cs.SWA_B, cs.SWA_T + 3) if swa else (cs.QWEN_B, cs.QWEN_T)
        c_len = cs.SWA_T + 3 if swa else cs.LM_C_T + 3
        faults = [("noncausal", noncausal), ("kvmod", kvmod)]
        if swa:
            faults.append(("wide", wide))
    else:
        cfg = cs.lm_config()
        faults = [("noncausal", noncausal)]
    V = cfg.vocab_size
    readings = []
    for seed in (int(s) for s in args.seeds.split(",")):
        g = torch.Generator(device=cs.DEVICE).manual_seed(seed)
        model = init_params(cfg, device=cs.DEVICE, generator=g)
        if dense:
            prompts = cs.dense_inputs(cfg, b, n, g)
            main_t = min(n, cs.SWA_T if swa else cs.QWEN_T)

            def pairs(**swap):
                return cs.dense_bf16_pairs(model, cfg, prompts[:, :main_t],
                                           prompts[:2, :c_len], **swap)

            c_cfg, c_toks = cfg, prompts[:2, :c_len]
        else:
            prompts = torch.randint(0, V, (cs.LM_B, cs.LM_T), generator=g,
                                    device=cs.DEVICE)

            def pairs(**swap):
                return cs.lm_bf16_pairs(model, cfg, prompts, **swap)

            c_cfg = cs.no_drop_config(cfg)
            c_toks = prompts[:2, :cs.LM_C_T + 3]
        runs = [("none", pairs())]
        runs += [(name, pairs(flash_fn=fn)) for name, fn in faults]
        with early_decode():
            runs.append(("early", {"(c)": cs.lm_invariant(
                model, c_cfg, c_toks)}))
        for fault, checks in runs:
            for what, pairs in checks.items():
                gap = cs.logit_gap(pairs, V)
                r = {"seed": seed, "fault": fault, "check": what[:3],
                     "ratio": gap["err"] / gap["scale"], "rms": gap["rms"],
                     "same": gap["same"], "n": gap["n"],
                     "flips": gap["flips"],
                     "passes": cs.bf16_gate(gap, args.arch)}
                readings.append(r)
                print(json.dumps(r), flush=True)
        del model, prompts, runs
        torch.cuda.empty_cache()

    summary = {"arch": args.arch, "gate": cs.BF16_GATES[args.arch]}
    for fault in ("none", "noncausal", "early", "kvmod", "wide"):
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
    out = Path(args.out or "chiprun_out/lm_gates"
               + ("" if args.arch == cs.LM_ARCH else f"_{args.arch}")
               + ".json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"readings": readings, "summary": summary},
                              indent=1))
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
