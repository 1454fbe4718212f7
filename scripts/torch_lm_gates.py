#!/usr/bin/env python3
"""Readings behind the bf16 gates of `chip_smoke.py`'s lm phase: checks (c)
and (d) on several model seeds, and the same checks with a fault put in,
which the gates must refuse.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/torch_lm_gates.py [--arch deepseek_v2_lite_16b] \\
        [--seeds 0,1,2,3,4,5,6,7] [--f32] [--out chiprun_out/lm_gates.json]

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
    decode x3 across its 4,096 window, (d) the 2 x 8,192 prefill;
  * jamba-v0.1-52b (the ssm phase's, at its 2 of 4 periods; seed 0 is its
    model and prompts): B=8 prompts of T=2,048, (c) prefill(256) + decode
    x3, (d) the 8 x 2,048 prefill 2 rows at a time with the plain
    flash_attention and topk, both with no token dropped
    (`chip_smoke.ssm_bf16_pairs`);
  * xlstm-350m (as configured): (c) alone (it runs no kernel); with
    `--f32`, its float32 checks instead (`f32_readings`).
jamba's (c) freezes every router choice of prefill(256) + decode to
prefill(259)'s (`chip_smoke.routed_invariant`).
The controls run the same two checks with a fault:
  * `noncausal`: the flash kernel without its causal mask, in (c) and in
    place of the plain versions in (d);
  * `early`: (c) with each decode step one position early (its rope
    angle and cache slot);
  * `kvmod` (GQA): query head h reads KV head h % KV in place of h // G,
    in (c) and (d);
  * `wide` (a window): the flash kernel's window one key too wide, in (c)
    and (d);
  * `stale` (recurrent layers): (c) decoding from the recurrent state
    init_cache made (zeros, m = -inf), not the one the prefill wrote;
  * `convshift` (recurrent layers): (c) with the conv states one position
    behind (those of a prefill over the prompt's first T - 1 tokens; the
    scans' states the whole prompt's). `early` cannot show a fault in
    xlstm: no layer of it reads the position.
Each reading is printed with whether `chip_smoke.bf16_gate` passes it
under the architecture's gate for that check (chip_smoke's BF16_GATES and
BF16_D_TOL), then, for each
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


RECURRENT = ("mamba", "mlstm", "slstm")


def recurrent_leaves(cache, cfg):
    """(name, leaf stacked over the periods) of every recurrent layer."""
    for i, spec in enumerate(cfg.pattern):
        if spec.kind in RECURRENT:
            yield from cache["periods"][str(i)].items()


@contextlib.contextmanager
def stale_state():
    """Every prefill_step with a cache leaves the recurrent layers' leaves
    as init_cache made them: zeros, and m = -inf."""
    from repro_torch.models import model as M

    saved = M.prefill_step

    def prefill(model, batch, cache, cfg):
        out = saved(model, batch, cache, cfg)
        for name, leaf in recurrent_leaves(cache or {"periods": {}}, cfg):
            leaf.fill_(-float("inf") if name in ("m", "sm") else 0.0)
        return out

    M.prefill_step = prefill
    try:
        yield
    finally:
        M.prefill_step = saved


@contextlib.contextmanager
def conv_behind():
    """Every prefill_step with a cache leaves the conv states one position
    behind: those of a prefill over the prompt's first T - 1 tokens (its
    router calls through the topk in place when the block began, so that
    a check that replays router choices sees only its own calls)."""
    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.transformer import init_cache

    saved, topk_fn = M.prefill_step, ops.topk

    def prefill(model, batch, cache, cfg):
        out = saved(model, batch, cache, cfg)
        if cache is not None:
            x = batch["inputs"]
            short = init_cache(cfg, x.shape[0], x.shape[1],
                               dtype=cfg.param_dtype, device=x.device)
            with cs.swapped_ops(topk_fn=topk_fn):
                saved(model, {"inputs": x[:, :-1]}, short, cfg)
            for (name, leaf), (_, behind) in zip(
                    recurrent_leaves(cache, cfg),
                    recurrent_leaves(short, cfg)):
                if name == "conv":
                    leaf.copy_(behind)
        return out

    M.prefill_step = prefill
    try:
        yield
    finally:
        M.prefill_step = saved


def f32_readings(cs, seeds, out) -> int:
    """xlstm-350m's float32 checks of chip_smoke.py at full width and depth
    on each seed: (c) prefill(256) + decode x3 against prefill(259), B=2,
    and the card's prefill(16) + decode x2 against the port's on the CPU
    (`chip_smoke.device_pairs`), without a fault and with `early`, `stale`
    and `convshift` (on the card's side only in the second). Each reading
    is the least tol that |d| <= tol + tol |want| passes, beside whether
    `chip_smoke.compare_logits` passes it under XLSTM_F32_TOL."""
    from repro_torch.models.transformer import init_params

    cfg = cs.ssm_config(cs.XLSTM_ARCH, param_dtype=torch.float32)
    V, (b, t) = cfg.vocab_size, cs.XLSTM_CPU_BT
    controls = [("none", contextlib.nullcontext), ("early", early_decode),
                ("stale", stale_state), ("convshift", conv_behind)]
    readings = []
    for seed in seeds:
        g = torch.Generator(device=cs.DEVICE).manual_seed(seed)
        model = init_params(cfg, device=cs.DEVICE, generator=g)
        c_toks = cs.dense_inputs(cfg, 2, cs.LM_C_T + 3, g)
        d_toks = cs.dense_inputs(cfg, b, t + 2, g)
        for fault, ctx in controls:
            with ctx():
                c = cs.lm_invariant(model, cfg, c_toks)
            cpu = cs.device_pairs(model, cfg, d_toks, fault=ctx)
            for check, pairs in (("(c)", c), ("cpu", cpu)):
                pairs = [(a[..., :V].float().cpu(), w[..., :V].float().cpu())
                         for a, w in pairs]
                gap = cs.logit_gap(pairs, V)
                tol = max(float(((a - w).abs() / (1 + w.abs())).max())
                          for a, w in pairs)
                greedy = all(m <= 2 * r for m, r in gap["flips"])
                r = {"seed": seed, "fault": fault, "check": check,
                     "tol": tol, "err": gap["err"], "scale": gap["scale"],
                     "same": gap["same"], "n": gap["n"],
                     "flips": gap["flips"],
                     "passes": tol <= cs.XLSTM_F32_TOL[check] and greedy}
                readings.append(r)
                print(json.dumps(r), flush=True)
        del model
        torch.cuda.empty_cache()
    summary = {"arch": cs.XLSTM_ARCH, "dtype": "float32",
               "gate": cs.XLSTM_F32_TOL}
    for fault, _ in controls:
        for check in ("(c)", "cpu"):
            rs = [r for r in readings
                  if r["fault"] == fault and r["check"] == check]
            summary[f"{fault} {check}"] = {
                "min_tol": min(r["tol"] for r in rs),
                "max_tol": max(r["tol"] for r in rs),
                "max_err": max(r["err"] for r in rs),
                "min_share": min(r["same"] / r["n"] for r in rs),
                "passed": sum(r["passes"] for r in rs), "of": len(rs)}
    path = Path(out or f"chiprun_out/lm_gates_{cs.XLSTM_ARCH}_f32.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"readings": readings, "summary": summary},
                               indent=1))
    print(json.dumps(summary, indent=1))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="deepseek_v2_lite_16b",
                    choices=("deepseek_v2_lite_16b", "qwen3_14b",
                             "h2o_danube3_4b", "jamba_v01_52b",
                             "xlstm_350m"))
    ap.add_argument("--seeds", default="0,1,2,3,4,5,6,7")
    ap.add_argument("--f32", action="store_true",
                    help="xlstm_350m's float32 checks in place of the bf16 "
                         "ones (f32_readings)")
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
    if args.f32:
        if args.arch != cs.XLSTM_ARCH:
            ap.error("--f32 reads xlstm_350m's float32 checks only")
        return f32_readings(cs, [int(s) for s in args.seeds.split(",")],
                            args.out)
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

    ssm = args.arch in (cs.JAMBA_ARCH, cs.XLSTM_ARCH)
    dense = args.arch != cs.LM_ARCH and not ssm
    if ssm:
        jamba = args.arch == cs.JAMBA_ARCH
        cfg = (cs.ssm_config(args.arch, num_periods=cs.JAMBA_PERIODS)
               if jamba else cs.ssm_config(args.arch))
        b, n = (cs.JAMBA_B, cs.JAMBA_T) if jamba else (cs.XLSTM_B, cs.XLSTM_T)
        faults = [("noncausal", noncausal), ("kvmod", kvmod)] if jamba else []
    elif dense:
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
        if ssm:
            prompts = cs.dense_inputs(cfg, b, n, g)

            def pairs(**swap):
                return cs.ssm_bf16_pairs(model, cfg, prompts,
                                         prompts[:2, :cs.LM_C_T + 3], **swap)

            c_cfg = cs.no_drop_config(cfg) if cfg.moe else cfg
            c_toks = prompts[:2, :cs.LM_C_T + 3]
        elif dense:
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
        controls = [("early", early_decode)]
        if ssm:
            controls += [("stale", stale_state), ("convshift", conv_behind)]
        for name, fault in controls:
            with fault():
                runs.append((name, {"(c)": cs.routed_invariant(
                    model, c_cfg, c_toks)[0]}))
        for fault, checks in runs:
            for what, pairs in checks.items():
                gap = cs.logit_gap(pairs, V)
                r = {"seed": seed, "fault": fault, "check": what[:3],
                     "what": what,
                     "ratio": gap["err"] / gap["scale"], "rms": gap["rms"],
                     "same": gap["same"], "n": gap["n"],
                     "flips": gap["flips"],
                     "passes": cs.bf16_gate(gap, args.arch, what[:3])}
                readings.append(r)
                print(json.dumps(r), flush=True)
        del model, prompts, runs
        torch.cuda.empty_cache()

    summary = {"arch": args.arch, "gate": cs.BF16_GATES[args.arch]}
    for fault in ("none", "noncausal", "early", "kvmod", "wide", "stale",
                  "convshift"):
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
