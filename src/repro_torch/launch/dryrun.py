"""Dry run of the LM cells (the reference's `launch/dryrun.py`): every
(arch x shape x mesh) cell's state, its sharding and its per-device
bytes, with the analytic roofline priced for the card (`launch/roofline.py
HW`), without a device.

The reference lowers and compiles each cell on 512 forced host devices
and reads XLA's memory analysis and HLO. Torch has no such compiler, so
the port works at the placement level: the cell's parameters (or train
state), inputs and cache are built on "meta" (shapes and dtypes, no
storage), `launch/sharding.py`'s specs place every leaf on the mesh, and
each leaf's per-device shard (`sharding.named`, `local_shape`) gives the
bytes a device holds. The record keeps the reference's field names:

  params_total, params_active   count_params over the port's leaves
  flops_per_dev, bytes_per_dev, coll_bytes_analytic, model_flops_*,
  useful_flops_ratio            launch/costmodel.py cell_costs
  compute_s / memory_s / collective_s / dominant / compute_fraction
                                roofline_terms over the analytic
                                collective bytes, at HW's rates
  lower_s                       seconds to build the state and its specs
  mem.argument_bytes            the step's arguments a device holds:
                                params or the train state, the batch or
                                the decode tokens, the cache, and `pos`
  mem.alias_bytes               of those, the donated state or cache
  mem.fits_hbm                  argument_bytes < HW().hbm_bytes (80 GB)

What only a compiler gives is left out of the record, not written as 0
(compile_s, flops_hlo_raw, bytes_hlo_raw, collectives_hlo_raw, hlo_bytes,
mem.output_bytes, mem.temp_bytes), and the port cannot check what rests
on it:
  * the collectives' lowering (which collectives run, and their bytes);
  * activation and temporary memory: the reference's xlstm-350m
    decode_32k cell (multi-pod) holds 177 MB of temporaries against 82 MB
    of arguments, so a fit judged on arguments alone is a lower bound;
  * sharding-propagation mismatches inside the step.
XLA also drops the arguments a step never reads (jax.jit's keep_unused
is False): xlstm-350m's decode reads no position, so its argument bytes
lack the 4 bytes of `pos` that the port counts.

The serve-FSDP rule (total params x 2 bytes / 16 > 6e9) and the cost
model's model axis of 16 are the reference's choices for its 16 GB chip,
kept so the records compare; they are not the H100's.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --out d.jsonl

Exit code 1 if any cell errors.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import sys
import time
import traceback

from repro_torch.configs import ARCHS, SHAPES, get_config, input_specs
from repro_torch.configs.shapes import ShapeCfg, cache_spec, shape_runnable
from repro_torch.launch.costmodel import cell_costs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import HW, model_flops, roofline_terms
from repro_torch.launch.sharding import (P, batch_specs, cache_specs, leaves,
                                         local_shape, named, param_specs,
                                         state_specs)
from repro_torch.models.params import _reference_path
from repro_torch.models.transformer import model_skeleton
from repro_torch.optim.adamw import adamw_init

__all__ = ["apply_variant", "analytic_terms", "count_params", "lower_cell",
           "main", "serve_fsdp_rule", "shard_bytes"]


def apply_variant(cfg, variant: str):
    """(cfg, state_mode) with the comma-joined levers of `variant` applied:
    'skip' (masked-block skipping), 'kvq' (int8 KV), 'zero1' (ZeRO-1
    sharding), 'accumN' (grad_accum=N)."""
    state_mode = "fsdp"
    for v in [x for x in variant.split(",") if x]:
        if v == "skip":
            cfg = dataclasses.replace(cfg, skip_masked_blocks=True)
        elif v == "kvq":
            cfg = dataclasses.replace(cfg, kv_quant=True)
        elif v == "zero1":
            state_mode = "zero1"
        elif v.startswith("accum"):
            cfg = dataclasses.replace(cfg, grad_accum=int(v[5:]))
        else:
            raise ValueError(f"unknown variant {v}")
    return cfg, state_mode


def count_params(cfg, params) -> tuple[float, float]:
    """(total, active) parameter counts of the port's leaves, by their
    reference paths; expert weights scaled by top_k / E."""
    total = active = 0.0
    for name, leaf in params.named_parameters():
        path = "/".join(_reference_path(name)[0])
        n = float(leaf.numel())
        total += n
        if "embed" in path or "head" in path:
            continue
        if ("moe" in path and ("w_in" in path or "w_out" in path)
                and "shared" not in path):
            n = n * cfg.moe.top_k / cfg.moe.num_experts
        active += n
    return total, active


def shard_bytes(tree, spec_tree, mesh) -> int:
    """Bytes a device holds of `tree` (a nested dict of tensors, or one
    tensor) under `spec_tree` (its specs, in its nesting)."""
    specs = dict(leaves(named(spec_tree, mesh)))
    total = 0
    for path, t in leaves(tree):
        shape = local_shape(t.shape, specs[path], mesh)
        n = 1
        for s in shape:
            n *= s
        total += n * t.element_size()
    return total


def serve_fsdp_rule(params_total: float) -> bool:
    """The reference's: serving keeps params TP-only when they fit
    comfortably (< ~6 GB a chip of 16 GB at bf16 over a model axis of 16),
    else keeps the 2D (FSDP) layout."""
    return (params_total * 2 / 16) > 6e9


def analytic_terms(cfg, shape: ShapeCfg, n_dev: int, model_ax: int,
                   serve_fsdp: bool, params_active: float,
                   state_mode: str) -> dict:
    """The record's cost-model fields: flops / bytes / collective bytes a
    device, the roofline terms at HW's rates over the analytic collective
    bytes, and the model FLOPs."""
    cost = cell_costs(cfg, shape.kind, shape.seq, shape.batch,
                      n_devices=n_dev, model_ax=model_ax,
                      dp_ax=max(n_dev // model_ax, 1),
                      fsdp=(shape.kind == "train" or serve_fsdp),
                      state_mode=state_mode)
    rec = {"flops_per_dev": cost.flops_per_dev,
           "bytes_per_dev": cost.bytes_per_dev,
           "coll_bytes_analytic": cost.coll_bytes_per_dev}
    rec.update(roofline_terms(cost.flops_per_dev, cost.bytes_per_dev,
                              cost.coll_bytes_per_dev))
    tokens = shape.batch * (1 if shape.kind == "decode" else shape.seq)
    mf = model_flops(params_active, tokens, shape.kind)
    rec["model_flops_total"] = mf
    rec["model_flops_per_dev"] = mf / n_dev
    if cost.flops_per_dev > 0:
        rec["useful_flops_ratio"] = mf / n_dev / cost.flops_per_dev
    return rec


def lower_cell(arch: str, shape, multi_pod: bool = False,
               variant: str = "", *, mesh=None) -> dict:
    """The record of one cell. `shape` is a name of SHAPES or a ShapeCfg;
    `mesh` (default: the production mesh, multi-pod or not: "mesh" is
    "single" / "multi") may be any `launch.mesh.Mesh`, e.g. one slot of a
    card ("mesh" is then its shape, "1x1")."""
    cfg, state_mode = apply_variant(get_config(arch), variant)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
        mesh_name = "multi" if multi_pod else "single"
    else:
        mesh_name = "x".join(str(n) for n in mesh.devices.shape)
    ok, why = shape_runnable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape.name, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    n_dev = mesh.size
    rec = {"arch": arch, "shape": shape.name, "variant": variant,
           "mesh": mesh_name, "devices": int(n_dev)}
    t0 = time.time()

    params = model_skeleton(cfg, "meta")
    total_p, active_p = count_params(cfg, params)
    rec["params_total"] = total_p
    rec["params_active"] = active_p
    serve_fsdp = serve_fsdp_rule(total_p)

    if shape.kind == "train":
        state = {"params": dict(params.named_parameters()),
                 "opt": adamw_init(params)}
        sspec = state_specs(state, mesh, fsdp=True, mode=state_mode)
        batch = input_specs(cfg, shape)
        args = [(state, sspec), (batch, batch_specs(batch, mesh))]
        donated = args[:1]
    else:
        pspec = param_specs(params, mesh, fsdp=serve_fsdp)
        pargs = (dict(params.named_parameters()), pspec)
        cache = cache_spec(cfg, shape)
        cargs = (cache, cache_specs(cache, mesh))
        if shape.kind == "prefill":
            batch = input_specs(cfg, shape)
            args = [pargs, (batch, batch_specs(batch, mesh)), cargs]
        else:
            inp = input_specs(cfg, shape)
            tokens = {"tokens": inp["tokens"]}
            args = [pargs, (tokens, batch_specs(tokens, mesh)), cargs,
                    (inp["pos"], P())]
        donated = [cargs]
    arg_bytes = sum(shard_bytes(t, s, mesh) for t, s in args)
    alias_bytes = sum(shard_bytes(t, s, mesh) for t, s in donated)
    rec["lower_s"] = round(time.time() - t0, 2)

    rec.update(analytic_terms(cfg, shape, n_dev, mesh.shape.get("model", 1),
                              serve_fsdp, active_p, state_mode))
    rec["mem"] = {"argument_bytes": int(arg_bytes),
                  "alias_bytes": int(alias_bytes),
                  "fits_hbm": bool(arg_bytes < HW().hbm_bytes)}
    rec["status"] = "ok"
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--variant", default="")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    out_f = open(args.out, "a") if args.out else None
    n_fail = 0
    try:
        for arch, shape, multi in itertools.product(archs, shapes, meshes):
            try:
                rec = lower_cell(arch, shape, multi, variant=args.variant)
            except Exception as e:  # a failure here is a system bug
                rec = {"arch": arch, "shape": shape,
                       "mesh": "multi" if multi else "single",
                       "status": "error", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
                n_fail += 1
            if out_f:
                out_f.write(json.dumps(rec) + "\n")
                out_f.flush()
            if not args.quiet:
                brief = {k: rec.get(k) for k in
                         ("arch", "shape", "mesh", "status", "dominant",
                          "compute_fraction", "error")}
                print(json.dumps(brief), flush=True)
            if rec.get("mem"):
                mem = rec["mem"]
                print(f"  arguments={mem['argument_bytes'] / 1e9:.2f}GB "
                      f"fits_hbm={mem['fits_hbm']}", file=sys.stderr)
    finally:
        if out_f:
            out_f.close()
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
