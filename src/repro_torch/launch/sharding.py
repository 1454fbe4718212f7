"""Path-based sharding rules, DP / FSDP / TP / EP / SP from one rule table
(the reference's `launch/sharding.py`), over the port's leaves.

Strategy (the reference's):
  * params: TP on `model` (heads / d_ff / experts / d_inner), FSDP on `data`
    for the orthogonal dim. Serving replicates the FSDP dim for models whose
    bf16 params fit at TP-only sharding (`launch/dryrun.py`), else keeps 2D.
  * optimizer state mirrors its param.
  * batch: global batch on (pod, data).
  * decode caches: batch on (pod, data) when divisible; KV sequence on
    `model`; B == 1 long-context shards the sequence on (data, model).

The rules read the reference's path of each leaf ("/periods/0/attn/wq";
`models/params.py _reference_path`). The reference stacks each period's
parameters on axis 0; the port keeps them as a leaf a period, so a
parameter's spec is the reference's without its leading None (and the
threshold of `_place_missing` reads the stacked size). Caches are
stacked over the periods in both packages, so their specs keep it.

A spec is the port's `PartitionSpec`: one entry a dimension, None, a mesh
axis name, or a tuple of names (the dimension split over their product,
the first axis major). `named` turns specs into DTensor placements (one
`Shard(d)` / `Replicate()` a mesh axis, in the mesh's axis order) and
`local_shape` gives a leaf's per-device shard from them; the dry run's
byte counts read them. Nothing here starts a process group.
"""

from __future__ import annotations

import torch

from repro_torch.launch.mesh import dp_axes, mesh_shape
from repro_torch.models.params import _reference_path

__all__ = ["PartitionSpec", "P", "param_specs", "batch_specs", "cache_specs",
           "state_specs", "named", "local_shape", "count_bytes", "leaves"]


class PartitionSpec(tuple):
    """One entry a tensor dimension: None (replicated), a mesh axis name,
    or a tuple of names; a tuple of one name is that name (as the
    reference's `jax.sharding.PartitionSpec` stores it)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def leaves(tree, prefix: str = ""):
    """(path, leaf) of a nested dict (keys in insertion order), a module
    (its named parameters, path "/"-joined) or a single leaf."""
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _named(params) -> dict:
    """name -> tensor of a parameter module or of a name -> tensor dict."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _divisible(n: int, axes, sizes) -> bool:
    total = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        total *= sizes[a]
    return n % total == 0


def _param_rule(path: str, shape, sizes, fsdp: bool) -> P:
    """The PartitionSpec of one param leaf, by its reference path."""
    dp = "data" if ("data" in sizes and fsdp) else None
    leaf = path.rsplit("/", 1)[-1]
    nd = len(shape)

    if leaf == "embed":
        return P("model", dp)                        # [V, d]
    if leaf == "head":
        return P(dp, None, "model")                  # [d, nH, V]
    if leaf in ("wq", "wk", "wv") and nd == 3:
        return P(dp, "model", None)                  # [d, H, hd]
    if leaf == "wo" and nd == 3:
        return P("model", None, dp)                  # [H, hd, d]
    if leaf in ("wq", "wk", "wv") and nd == 2:       # mlstm [di, di]
        return P(None, "model")
    if leaf == "w_dkv":
        return P(dp, None)                           # [d, lora+rope]
    if leaf in ("w_uk", "w_uv"):
        return P(None, "model", None)                # [lora, H, x]
    if leaf == "w_in" and nd == 4:
        return P("model", dp, None, None)            # MoE [E, d, 2, F]
    if leaf == "w_out" and nd == 3 and "moe" in path:
        return P("model", None, dp)                  # MoE [E, F, d]
    if leaf in ("w_in", "shared_w_in", "ffn_in") and nd == 3:
        return P(dp, None, "model")                  # GLU [d, 2, F]
    if leaf in ("w_in", "shared_w_in") and nd == 2:
        return P(dp, "model")                        # dense [d, F]
    if leaf in ("w_out", "shared_w_out", "ffn_out") and nd == 2:
        return P("model", dp)                        # [F, d]
    if leaf == "router":
        return P(dp, None)                           # [d, E]
    if leaf in ("in_proj",):
        return P(dp, None, "model")                  # [d, 2, di]
    if leaf == "dt_proj":
        return P(dp, "model")                        # [r, di]: di rides model
    if leaf == "out_proj":
        return P("model", dp) if nd == 2 else P("model")
    if leaf in ("x_proj",):
        return P("model", None)                      # [di, r+2S]
    if leaf in ("conv_w",):
        return P(None, "model")                      # [K, di]
    if leaf in ("A_log",):
        return P("model", None)                      # [di, S]
    if leaf in ("conv_b", "dt_bias", "D", "gn_scale", "skip", "w_i", "w_f"):
        return P("model") if nd == 1 else P("model", None)
    if leaf == "w_gates":
        return P(dp, None, None, "model")            # slstm [d, 4, H, dh]
    if leaf == "r_gates":
        return P(None, None, "model", None)          # [4, H, dh, dh]
    if leaf == "b_gates":
        return P(None, None, None)
    # norms / scalars / fallback: replicate
    return P(*([None] * nd))


def _sanitize(spec: P, shape, sizes) -> P:
    """Drop mesh axes whose size does not evenly divide the dim (the
    reference's explicit input shardings require exact tiling)."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            out.append(None)
            continue
        axs = ax if isinstance(ax, tuple) else (ax,)
        total = 1
        for a in axs:
            total *= sizes[a]
        out.append(ax if (total and dim % total == 0) else None)
    return P(*out)


def _place_missing(spec: P, shape, sizes, want=("model",)) -> P:
    """If a wanted mesh axis was dropped (non-divisible dim), re-home it:
    first on an unsharded dim it divides, else combined with an existing
    axis tuple on a dim both divide. Keeps big-param leaves sharded even
    when the 'natural' dim is awkward (40 heads, 49155 vocab, ...)."""
    entries = list(tuple(spec) + (None,) * (len(shape) - len(spec)))
    used = set()
    for e in entries:
        for a in (e if isinstance(e, tuple) else (e,) if e else ()):
            used.add(a)
    for ax in want:
        if ax in used:
            continue
        placed = False
        for i in range(len(shape) - 1, -1, -1):       # prefer trailing dims
            if entries[i] is None and shape[i] % sizes[ax] == 0:
                entries[i] = ax
                placed = True
                break
        if not placed:
            for i in range(len(shape)):
                e = entries[i]
                if e is None:
                    continue
                cur = e if isinstance(e, tuple) else (e,)
                total = sizes[ax]
                for a in cur:
                    total *= sizes[a]
                if shape[i] % total == 0:
                    entries[i] = tuple(cur) + (ax,)
                    break
    return P(*entries)


def param_specs(params, mesh, *, fsdp: bool = True) -> dict:
    """name -> PartitionSpec of a parameter module, or of a name -> tensor
    dict of its names (the optimizer's m / v). A period's leaf takes the
    reference's rule for its stacked leaf, without the stack's axis."""
    sizes = mesh_shape(mesh)
    named = _named(params)
    periods = 1 + max((int(n.split(".")[1]) for n in named
                       if n.startswith("periods.")), default=0)
    out = {}
    for name, leaf in named.items():
        path, period = _reference_path(name)
        shape = tuple(leaf.shape)
        p = "/" + "/".join(path)
        spec = _sanitize(_param_rule(p, shape, sizes, fsdp), shape, sizes)
        stacked = leaf.numel() * (periods if period is not None else 1)
        if stacked >= 1 << 16:      # only big leaves worth re-homing
            spec = _place_missing(spec, shape, sizes)
        out[name] = spec
    return out


def state_specs(state, mesh, *, fsdp: bool = True, mode: str = "fsdp"
                ) -> dict:
    """Specs of {"params": module, "opt": {"m", "v": name -> tensor,
    "step"}}.

    mode="fsdp"  : params AND optimizer state sharded on `data`.
    mode="zero1" : params replicated on `data`, optimizer m/v still
                   data-sharded.
    """
    opt = state["opt"]
    return {
        "params": param_specs(state["params"], mesh,
                              fsdp=(fsdp and mode == "fsdp")),
        "opt": {"m": param_specs(opt["m"], mesh, fsdp=fsdp),
                "v": param_specs(opt["v"], mesh, fsdp=fsdp),
                "step": P()},
    }


def batch_specs(batch: dict, mesh) -> dict:
    """name -> spec of a batch dict: the leading (batch) dim on the data
    axes where they divide it; a 0-d entry replicated."""
    sizes = mesh_shape(mesh)
    dp = dp_axes(mesh)
    out = {}
    for name, leaf in batch.items():
        if leaf.dim() == 0:
            out[name] = P()
            continue
        lead = dp if _divisible(leaf.shape[0], dp, sizes) else None
        out[name] = P(lead, *([None] * (leaf.dim() - 1)))
    return out


def _cache_rule(path: str, shape, sizes, dp) -> P:
    name = path.rsplit("/", 1)[-1]
    stacked = path.startswith("/periods/")
    shape = shape[1:] if stacked else shape

    def out(spec):
        return P(None, *spec) if stacked else spec

    b = shape[0]
    nd = len(shape)
    b_ax = dp if _divisible(b, dp, sizes) else None
    if name in ("k", "v", "ks", "vs"):   # [B, S, KV, hd|1]
        s_ax = ("model",) if b_ax else ("data", "model")
        s_ax = s_ax if _divisible(shape[1], s_ax, sizes) else None
        return out(P(b_ax, s_ax, None, None))
    if name in ("c", "kr"):         # MLA [B, S, lora]
        s_ax = ("model",) if b_ax else ("data", "model")
        s_ax = s_ax if _divisible(shape[1], s_ax, sizes) else None
        return out(P(b_ax, s_ax, None))
    if name == "conv":              # [B, K-1, di]
        m = "model" if _divisible(shape[2], "model", sizes) else None
        return out(P(b_ax, None, m))
    if name == "ssm":               # [B, di, S]
        m = "model" if _divisible(shape[1], "model", sizes) else None
        return out(P(b_ax, m, None))
    if name == "C":                 # mlstm [B, H, dh, dh]
        m = "model" if _divisible(shape[2], "model", sizes) else None
        return out(P(b_ax, None, m, None))
    if name in ("n", "sc", "sn", "sh", "sm") and nd == 3:  # [B, H, dh]
        m = "model" if _divisible(shape[2], "model", sizes) else None
        return out(P(b_ax, None, m))
    if nd >= 1:
        return out(P(b_ax, *([None] * (nd - 1))))
    return out(P())


def cache_specs(cache: dict, mesh) -> dict:
    """The decode / prefill cache's specs, in its nesting (see the module
    docstring)."""
    sizes = mesh_shape(mesh)
    dp = dp_axes(mesh)

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}") for k, v in tree.items()}
        return _cache_rule(prefix, tuple(tree.shape), sizes, dp)

    return walk(cache, "")


def _map_specs(fn, tree):
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    return {k: _map_specs(fn, v) for k, v in tree.items()}


def named(spec_tree, mesh):
    """Each spec as DTensor placements over `mesh`: a tuple, one a mesh
    axis in its order, `Shard(d)` where the spec puts that axis on dim d,
    else `Replicate()`."""
    from torch.distributed.tensor import Replicate, Shard

    def one(spec):
        out = [Replicate()] * len(mesh.axis_names)
        for d, e in enumerate(spec):
            for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                out[mesh.axis_names.index(a)] = Shard(d)
        return tuple(out)

    return _map_specs(one, spec_tree)


def local_shape(shape, placements, mesh) -> tuple[int, ...]:
    """The per-device shard of a tensor of `shape` under `placements`
    (`named`); raises where a mesh axis does not divide its dim."""
    out = list(shape)
    for size, pl in zip(mesh.devices.shape, placements):
        if pl.is_shard():
            if out[pl.dim] % size:
                raise ValueError(f"dim {pl.dim} of {tuple(shape)} does not "
                                 f"split over {size} slots")
            out[pl.dim] //= size
    return tuple(out)


def count_bytes(tree) -> int:
    """Bytes of every leaf of a nested dict, module or tensor."""
    return sum(t.numel() * t.element_size() for _, t in leaves(tree))
