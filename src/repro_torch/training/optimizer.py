"""AdamW with global-norm clipping and a cosine schedule, ported from the JAX
package's ``training/optimizer.py`` as plain functions on tensors.

Parameters, gradients and moments are dicts of tensors keyed alike (an
``nn.Module``'s ``named_parameters()`` for a model).  The arithmetic is
JAX's, in its order: the clip scale ``min(1, clip / (‖g‖ + 1e-9))``, bias
corrections from the incremented step, weight decay inside the step's delta,
``p − lr·delta`` in f32 cast back to the parameter's dtype.  Moments are f32.
``torch.optim.AdamW`` is not used: its decoupled decay and its bias
corrections are another arithmetic.  The schedule and the bias corrections
are host numbers, computed in f32 as JAX computes them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch import nn


class AdamWState(NamedTuple):
    step: torch.Tensor        # () int32 on the CPU: updates taken
    m: dict                   # first moments, f32, keyed as the parameters
    v: dict                   # second moments, f32


@dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def named(params) -> dict:
    """``params`` as a dict of tensors: a module's ``named_parameters()``,
    or the dict itself."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def cosine_lr(cfg: AdamWConfig, step) -> float:
    """Learning rate after ``step`` updates: linear warmup to ``lr_peak``
    over ``warmup_steps``, then a cosine to 0 at ``total_steps``, in f32."""
    f32 = np.float32
    s = f32(int(step))
    warm = f32(cfg.lr_peak) * s / f32(max(cfg.warmup_steps, 1))
    prog = np.clip((s - f32(cfg.warmup_steps))
                   / f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   f32(0.0), f32(1.0))
    cos = f32(0.5 * cfg.lr_peak) * (f32(1.0) + np.cos(f32(np.pi) * prog))
    return float(warm if s < cfg.warmup_steps else cos)


def adamw_init(params) -> AdamWState:
    """Zero f32 moments beside every parameter, step 0."""
    zeros = {k: torch.zeros_like(p, dtype=torch.float32)
             for k, p in named(params).items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32),
                      m=zeros, v={k: z.clone() for k, z in zeros.items()})


def global_norm(tensors) -> torch.Tensor:
    """√ of the sum, leaf after leaf, of each tensor's f32 sum of squares."""
    total = None
    for g in tensors:
        sq = g.float().square().sum()
        total = sq if total is None else total + sq
    return total.sqrt()


@torch.no_grad()
def adamw_update(grads: dict, state: AdamWState, params, cfg: AdamWConfig):
    """One AdamW update of ``params`` (a module or a dict of tensors) by
    ``grads`` (a dict keyed as ``named(params)``).  Parameters and moments
    are updated in place.  Returns (params, the new state, metrics
    ``{"grad_norm": tensor, "lr": float}``)."""
    gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = int(state.step) + 1
    lr = cosine_lr(cfg, step)
    f32 = np.float32
    b1c = float(f32(1.0) - f32(cfg.b1) ** f32(step))
    b2c = float(f32(1.0) - f32(cfg.b2) ** f32(step))
    for k, p in named(params).items():
        g = grads[k].float() * scale
        m, v = state.m[k], state.v[k]
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        delta = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        delta.add_(cfg.weight_decay * p.float())
        p.copy_(p.float() - lr * delta)
    new_state = AdamWState(torch.tensor(step, dtype=torch.int32),
                           state.m, state.v)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
