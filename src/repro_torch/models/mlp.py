"""MLP blocks: SwiGLU (decoder LMs) and GeLU (encoder-only, hubert-style)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dense_init


def init_mlp(generator: torch.Generator, d: int, ff: int, dtype, device,
             gated: bool = True) -> dict:
    """Gate, up and down projections of one SwiGLU MLP, or with ``gated``
    off the up and down projections of a GeLU MLP."""
    if gated:
        return {"w_gate": dense_init(generator, d, ff, dtype, device),
                "w_up": dense_init(generator, d, ff, dtype, device),
                "w_down": dense_init(generator, ff, d, dtype, device)}
    return {"w_up": dense_init(generator, d, ff, dtype, device),
            "w_down": dense_init(generator, ff, d, dtype, device)}


def mlp_forward(params, x: torch.Tensor) -> torch.Tensor:
    """``(silu(x W_gate) * x W_up) W_down``, or without a gate
    ``gelu(x W_up) W_down`` in the tanh form, which is ``jax.nn.gelu``'s
    default (the erf form differs by about 1e-3 of the value)."""
    if "w_gate" in params:
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    return h @ params["w_down"]
