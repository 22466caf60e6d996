"""Common model building blocks: dtype policy, device choice, RMSNorm, RoPE,
initializers, the causal depthwise conv of the SSM mixer.

Plain functions on tensors, ported from the JAX package's ``models/common.py``
(forward only).  Initializers draw from an explicit ``torch.Generator`` that
lives on the device the weights are made on; there is no global RNG state.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DtypePolicy:
    """Parameter, compute and accumulation dtypes of one model run."""

    params: torch.dtype = torch.float32
    compute: torch.dtype = torch.bfloat16
    accum: torch.dtype = torch.float32

    @staticmethod
    def serve() -> "DtypePolicy":
        """bf16 weights and compute."""
        return DtypePolicy(torch.bfloat16, torch.bfloat16, torch.float32)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names a GPU and none
    is present (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA GPU is "
                           f"available; pass device='cpu' to run on the CPU")
    return dev


def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype,
               device) -> torch.Tensor:
    """(d_in, d_out) weight, N(0, 1/d_in), drawn in f32 then cast."""
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32,
                    device=device)
    return (w * (1.0 / np.sqrt(d_in))).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    """(vocab, d) embedding table, N(0, 0.02²), drawn in f32 then cast."""
    w = torch.randn((vocab, d), generator=generator, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the ``1 + scale`` weight, computed in f32 and returned in
    ``x``'s dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return (xf * inv * (1.0 + scale.float())).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies ``theta^(-2i/head_dim)``, i < head_dim/2."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split rotary embedding.  x (..., S, H, hd); positions
    broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                     # (hd/2,)
    angles = positions[..., None].float() * freqs               # (..., S, hd/2)
    sin = torch.sin(angles)[..., None, :]                       # (..., S, 1, hd/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over time via shifted adds.  x (B, S, D);
    w (W, D) with ``w[-1]`` multiplying the current step."""
    W, S = w.shape[0], x.shape[1]
    out = x * w[-1]
    for i in range(1, W):
        shifted = torch.nn.functional.pad(x, (0, 0, i, 0))[:, :S, :]
        out = out + shifted * w[W - 1 - i]
    return out


def conv_decode_step(x_t: torch.Tensor, conv_state: torch.Tensor,
                     w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step of the causal depthwise conv.  x_t (B, D);
    conv_state (B, W-1, D) past inputs, oldest first.  Returns (y (B, D),
    the new state)."""
    full = torch.cat([conv_state, x_t[:, None, :]], dim=1)     # (B, W, D)
    y = torch.einsum("bwd,wd->bd", full, w)
    return y, full[:, 1:, :]
