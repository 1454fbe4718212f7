"""The reference's parameter pytree <-> the port's parameter module, and
a train state both ways.

`params_from_reference(tree, cfg)` takes the nested dict that
`repro.models.transformer.init_params` returns, as numpy arrays (or
anything `np.asarray` reads, bf16 included), and copies it into
`model_skeleton(cfg)`: "embed" (token inputs only), "prefix"/"<i>"/...,
"final_norm" and "head" [d, heads, V] (unless tied) leaf for leaf, and
"periods", whose leaves the reference stacks over the periods on axis 0
(`jax.vmap` of one period's init), split by period. Every leaf must be
present with its shape, and nothing else. Leaves may be numpy arrays,
jax arrays or tensors (bf16 included).

A train state is {"params", "opt": {"m", "v", "step"}}. In the port
"params" is the parameter module and "m" and "v" map each parameter's
name (`named_parameters()`, e.g. "periods.1.0.attn.wq") to a float32
tensor; in the reference all three are its parameter tree.
`train_state_to_reference` gives the reference's layout (host tensors,
the periods stacked on axis 0), the layout the port's checkpoints of a
train state are written in, so each package restores the other's;
`train_state_from_reference` takes it back. `reference_order` is the
reference's leaf order (its sorted keys, the periods of a stacked leaf
in order), the order the optimizer visits the leaves in.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.transformer import ModelConfig, model_skeleton

__all__ = ["params_from_reference", "reference_order",
           "train_state_from_reference", "train_state_to_reference",
           "tree_to_reference"]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _period(tree, p: int):
    """Period p's slice of a tree whose leaves are stacked on axis 0."""
    if isinstance(tree, dict):
        return {k: _period(v, p) for k, v in tree.items()}
    return _f32(tree)[p]


def _reference_path(name: str) -> tuple[tuple[str, ...], int | None]:
    """A port parameter name -> (the reference's key path, the period of
    its stacked leaf, or None outside "periods")."""
    parts = tuple(name.split("."))
    if parts[0] == "periods":
        return ("periods",) + parts[2:], int(parts[1])
    return parts, None


def reference_order(names) -> list[str]:
    """The names in the reference's leaf order."""
    def key(n):
        path, per = _reference_path(n)
        return path, -1 if per is None else per

    return sorted(names, key=key)


def tree_to_reference(named: dict, cfg: ModelConfig) -> dict:
    """name -> tensor as the reference's nested tree on the host, the
    periods' leaves stacked on axis 0."""
    tree: dict = {}
    stacks: dict = {}
    for name, t in named.items():
        path, per = _reference_path(name)
        if per is not None:
            stacks.setdefault(path, [None] * cfg.num_periods)[per] = t
            continue
        _put(tree, path, t.detach().cpu())
    for path, parts in stacks.items():
        _put(tree, path, torch.stack([t.detach().cpu() for t in parts]))
    return tree


def _put(tree: dict, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _tree_from_reference(tree, names, device) -> dict:
    """The reference's tree -> name -> float32 tensor on `device`."""
    out = {}
    for name in names:
        path, per = _reference_path(name)
        leaf = tree
        for k in path:
            leaf = leaf[k]
        a = _f32(leaf)
        out[name] = torch.from_numpy(np.array(a if per is None else a[per])
                                     ).to(device)
    return out


def _fill(module, tree, path: str):
    names = set(module._parameters) | set(module._modules)
    if set(tree) != names:
        raise ValueError(f"{path or 'params'}: the reference has keys "
                         f"{sorted(tree)}, the port {sorted(names)}")
    for name, value in tree.items():
        where = f"{path}/{name}" if path else name
        if name in module._modules:
            _fill(module._modules[name], value, where)
            continue
        p = module._parameters[name]
        a = _f32(value)
        if a.shape != tuple(p.shape):
            raise ValueError(f"{where}: reference shape {a.shape}, port "
                             f"{tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(a)))


@torch.no_grad()
def params_from_reference(tree, cfg: ModelConfig, *, device=None):
    """The port's parameter module holding the reference's values, on
    `device` (default: the card; raises without one) in
    `cfg.param_dtype`."""
    model = model_skeleton(cfg, resolve_device(device))
    tree = dict(tree)
    tree["periods"] = {str(p): _period(tree["periods"], p)
                       for p in range(cfg.num_periods)}
    _fill(model, tree, "")
    return model


def train_state_to_reference(state: dict, cfg: ModelConfig) -> dict:
    """The port's train state in the reference's layout: {"params", "opt":
    {"m", "v", "step"}}, host tensors (params in their dtype, m and v
    float32, step a 0-d int32), the periods stacked on axis 0."""
    opt = state["opt"]
    params = dict(state["params"].named_parameters())
    return {"params": tree_to_reference(params, cfg),
            "opt": {"m": tree_to_reference(opt["m"], cfg),
                    "v": tree_to_reference(opt["v"], cfg),
                    "step": torch.as_tensor(opt["step"]).detach().to(
                        "cpu", torch.int32)}}


def train_state_from_reference(state: dict, cfg: ModelConfig, *,
                               device=None) -> dict:
    """A train state in the reference's layout (arrays or tensors) -> the
    port's on `device` (default: the card; raises without one): the
    parameter module in `cfg.param_dtype` with requires_grad on, m and v
    float32, step a 0-d int32 tensor."""
    dev = resolve_device(device)
    model = params_from_reference(state["params"], cfg, device=dev)
    model.requires_grad_(True)
    names = [n for n, _ in model.named_parameters()]
    opt = state["opt"]
    step = torch.tensor(int(opt["step"]), dtype=torch.int32, device=dev)
    return {"params": model,
            "opt": {"m": _tree_from_reference(opt["m"], names, dev),
                    "v": _tree_from_reference(opt["v"], names, dev),
                    "step": step}}
