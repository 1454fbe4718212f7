"""AdamW with a cosine schedule and global-norm clipping (the reference's
`optim/adamw.py`).

The state and the arithmetic are the reference's: `m` and `v` are float32
whatever the parameters' dtype, each gradient is cast to float32 and
scaled by the clip factor, the new parameter is computed in float32 and
cast back to the parameter's dtype. Every leaf is updated in place by
its own plain ops, one after another in the order the caller gives (the
reference's leaf order, `models.params.reference_order`): no fused or
foreach kernel, which would round differently. The schedule and the bias
corrections are 0-d float32 tensors on the parameters' device, so a step
reads nothing back to the host.

Parameters, gradients, `m` and `v` are mappings of name -> tensor (a
module's `named_parameters()` in the train step); `step` is a 0-d int32
tensor.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr",
           "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _f32(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def cosine_lr(cfg: AdamWConfig, step):
    """Learning rate at `step` (an int or an integer tensor), a 0-d
    float32 tensor: linear warm-up over warmup_steps, then a cosine from
    lr down to min_lr_frac * lr at total_steps."""
    dev = step.device if torch.is_tensor(step) else None
    step = _f32(step, dev)
    warm = torch.minimum(step / max(cfg.warmup_steps, 1), _f32(1.0, dev))
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_init(params) -> dict:
    """{"m", "v": float32 zeros of each parameter's shape, "step": 0}."""
    named = dict(params.named_parameters() if isinstance(
        params, torch.nn.Module) else params)
    dev = next(iter(named.values())).device
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in named.items()}
    return {"m": zeros, "v": {n: z.clone() for n, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tensors):
    """sqrt of the sum of every tensor's float32 sum of squares, the
    tensors summed in the order given."""
    total = 0.0
    for x in tensors:
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(_f32(total))


def adamw_update(cfg: AdamWConfig, params, grads, opt_state):
    """One AdamW step, written in place: each leaf's new parameter, m and
    v are computed with the reference's expressions and copied into
    `params[n]`, `opt_state["m"][n]` and `opt_state["v"][n]` before the
    next leaf, so only one leaf's temporaries sit beside the state (the
    reference's functional update relies on XLA's buffer donation).
    `params` and `grads` map the same names to tensors; the parameters
    keep their dtypes. Returns (params, opt_state with the new "step",
    {"grad_norm", "lr"})."""
    step = opt_state["step"] + 1
    gn = global_norm(grads[n] for n in params)
    scale = torch.minimum(_f32(1.0, gn.device),
                          cfg.clip_norm / torch.clamp_min(gn, 1e-9))
    lr = cosine_lr(cfg, step)
    stepf = step.float()
    b1c = 1 - _f32(cfg.b1, gn.device) ** stepf
    b2c = 1 - _f32(cfg.b2, gn.device) ** stepf
    with torch.no_grad():
        for n, p in params.items():
            g = grads[n].float() * scale
            m = cfg.b1 * opt_state["m"][n] + (1 - cfg.b1) * g
            v = cfg.b2 * opt_state["v"][n] + (1 - cfg.b2) * torch.square(g)
            mh, vh = m / b1c, v / b2c
            pf = p.float()
            p_new = pf - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                               + cfg.weight_decay * pf)
            opt_state["m"][n].copy_(m)
            opt_state["v"][n].copy_(v)
            p.copy_(p_new)
            del g, m, v, mh, vh, pf, p_new
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gn, "lr": lr}
