"""SwiGLU MLP block of the decoder LMs."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dense_init


def init_mlp(generator: torch.Generator, d: int, ff: int, dtype,
             device) -> dict:
    """Gate, up and down projections of one SwiGLU MLP."""
    return {"w_gate": dense_init(generator, d, ff, dtype, device),
            "w_up": dense_init(generator, d, ff, dtype, device),
            "w_down": dense_init(generator, ff, d, dtype, device)}


def mlp_forward(params, x: torch.Tensor) -> torch.Tensor:
    """``(silu(x W_gate) * x W_up) W_down``."""
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]
