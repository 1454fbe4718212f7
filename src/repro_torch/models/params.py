"""The reference's parameter pytree -> the port's parameter module.

`params_from_reference(tree, cfg)` takes the nested dict that
`repro.models.transformer.init_params` returns, as numpy arrays (or
anything `np.asarray` reads, bf16 included), and copies it into
`model_skeleton(cfg)`: "embed" (token inputs only), "prefix"/"<i>"/...,
"final_norm" and "head" [d, heads, V] (unless tied) leaf for leaf, and
"periods", whose leaves the reference stacks over the periods on axis 0
(`jax.vmap` of one period's init), split by period. Every leaf must be
present with its shape, and nothing else.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.transformer import ModelConfig, model_skeleton

__all__ = ["params_from_reference"]


def _period(tree, p: int):
    """Period p's slice of a tree whose leaves are stacked on axis 0."""
    if isinstance(tree, dict):
        return {k: _period(v, p) for k, v in tree.items()}
    return np.asarray(tree, dtype=np.float32)[p]


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
        a = np.asarray(value, dtype=np.float32)
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
