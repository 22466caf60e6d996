"""RG-LRU recurrent block (RecurrentGemma / Griffin) [arXiv:2402.19427].

Ported from the JAX package's ``models/rglru.py``:

    r_t = σ(W_a u_t + b_a)            recurrence gate
    i_t = σ(W_x u_t + b_x)            input gate
    a_t = exp(−c · softplus(Λ) · r_t) (c = 8)
    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ u_t)

The block is Griffin's recurrent layer: a GeLU (tanh form, ``jax.nn.gelu``'s
default) gate branch and a conv → RG-LRU branch, multiplied, then the output
projection.  Prefill runs the linear recurrence as a log-depth
(Hillis–Steele) scan of the pairs (a, b) in f32 tensor ops, ⌈log₂ S⌉ steps,
where the JAX package runs ``jax.lax.associative_scan``; it is no Pallas
kernel there, and no CUDA kernel here.  The training forward
(``rglru_forward(..., train=True)``, no state read) is the same block;
autograd differentiates the scan, which runs under
``torch.utils.checkpoint``: its ⌈log₂ S⌉ steps would each keep a (B, S, w)
f32 pair for the backward (134 MB a tensor at 2 × 4096 × 4096), and
recomputed they cost a few elementwise passes.  Decode carries ``{"h": (B,
w) f32, "conv": (B, W-1, w)}`` and updates it in place.

Unlike the JAX prefill, ``rglru_forward`` takes per-row ``true_lens``: a
right-padded row's state is ``h`` at ``true_len - 1`` and its conv tail
ends there, so each row's cache is that of the row alone (the JAX prefill
reads the padded sequence's last step).  The state is rounded as JAX
rounds it: the scan's f32 ``h`` is cast to the compute dtype, then the
row's last step back to f32 for the cache.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from .common import causal_depthwise_conv, conv_decode_step, conv_tail, dense_init

_C = 8.0


def init_rglru(generator: torch.Generator, cfg: ModelConfig, dtype,
               device) -> dict:
    """Fresh block weights (the JAX initializer's 9 leaves and
    distributions; gate biases and Λ in f32)."""
    d, w = cfg.d_model, cfg.rnn_width
    f32 = dict(dtype=torch.float32, device=device)
    w_gate_in = dense_init(generator, d, w, dtype, device)
    w_x_in = dense_init(generator, d, w, dtype, device)
    conv_w = torch.randn((cfg.conv_width, w), generator=generator, **f32) * 0.2
    return {
        "w_gate_in": w_gate_in,
        "w_x_in": w_x_in,
        "conv_w": conv_w.to(dtype),
        "w_a": dense_init(generator, w, w, dtype, device),
        "b_a": torch.zeros((w,), **f32),
        "w_i": dense_init(generator, w, w, dtype, device),
        "b_i": torch.zeros((w,), **f32),
        "lam": torch.full((w,), 0.5, **f32),                     # Λ
        "w_out": dense_init(generator, w, d, dtype, device),
    }


def _gates(params, u):
    """(a, b) of the recurrence ``h = a·h + b``, both f32, for the
    post-conv input u (..., w)."""
    r = torch.sigmoid((u @ params["w_a"]).float() + params["b_a"])
    i = torch.sigmoid((u @ params["w_i"]).float() + params["b_i"])
    log_a = -_C * F.softplus(params["lam"]) * r                  # (..., w) f32
    a = torch.exp(log_a)
    scale = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, scale * i * u.float()


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` from ``h_{-1} = 0`` along axis 1 of (B,
    S, w) f32 tensors, as a Hillis–Steele scan: at distance d = 1, 2, 4, …
    every position t >= d folds in the pair at t - d, ``(a, b)[t] =
    (a[t] a[t-d], b[t] + a[t] b[t-d])``; ⌈log₂ S⌉ steps of whole-tensor
    ops.  Returns h (B, S, w)."""
    S = a.shape[1]
    d = 1
    while d < S:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b_prev], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a_prev], dim=1)
        d *= 2
    return b


def rglru_forward(params, x, cfg: ModelConfig, *, true_lens=None,
                  return_state: bool = False, train: bool = False):
    """Full-sequence Griffin recurrent block.  x (B, S, d); ``true_lens``
    (B,) the real length of each right-padded row, or None for all S.
    Returns y (B, S, d), and with ``return_state`` (prefill) also the
    decode cache after each row's last real position.  ``train`` runs the
    scan under ``torch.utils.checkpoint`` (the training forward)."""
    gate = F.gelu(x @ params["w_gate_in"], approximate="tanh")
    u = x @ params["w_x_in"]
    u_conv = F.silu(causal_depthwise_conv(u, params["conv_w"]))
    a, b = _gates(params, u_conv)                                # (B,S,w) f32
    h = (checkpoint(linear_scan, a, b, use_reentrant=False) if train
         else linear_scan(a, b)).to(x.dtype)
    y = (h * gate) @ params["w_out"]
    if not return_state:
        return y
    B_, S = x.shape[:2]
    last = (torch.full((B_,), S - 1, device=x.device) if true_lens is None
            else true_lens.to(x.device).long() - 1)
    # in the compute dtype and back to f32, as JAX rounds its state
    h_last = h[torch.arange(B_, device=x.device), last].float()
    return y, {"h": h_last, "conv": conv_tail(u, cfg.conv_width, true_lens)}


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """Zero decode cache of one RG-LRU layer: ``h`` in f32, the conv state
    in ``dtype``."""
    w = cfg.rnn_width
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                                device=device)}


def rglru_decode(params, x, cache: dict, cfg: ModelConfig):
    """One decode step.  x (B, 1, d).  ``cache`` is updated **in place**.
    Returns (y (B, 1, d), cache)."""
    x0 = x[:, 0, :]
    gate = F.gelu(x0 @ params["w_gate_in"], approximate="tanh")
    u = x0 @ params["w_x_in"]
    u_c, conv_state = conv_decode_step(u, cache["conv"].to(u.dtype),
                                       params["conv_w"])
    a, b = _gates(params, F.silu(u_c))                           # (B, w)
    h = a * cache["h"] + b
    y = ((h.to(x.dtype) * gate) @ params["w_out"])[:, None, :]
    cache["h"].copy_(h)
    cache["conv"].copy_(conv_state)
    return y, cache
