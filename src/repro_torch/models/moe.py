"""Mixture-of-Experts layers (deepseek-v2-lite), ported from the JAX
package's ``models/moe.py``.

Two execution paths, selected by ``impl``:

* ``dense``    — every expert on every token, combined by router weights.
                 O(E·N·d·ff) compute: only for tiny smoke configs;
* ``dropping`` — Switch-style capacity dispatch: positions within each
                 expert from an exclusive cumsum of a one-hot in token-major
                 (token, choice) order, a scatter-add into (E, C, d) expert
                 buffers, batched expert products (``torch.bmm``, as the JAX
                 package leaves them to XLA) and a gather back.  The
                 engine's default.

Both share the router: softmax over expert logits in f32, top-k, gates
renormalised over the chosen k.  Tokens past an expert's capacity are
dropped (their gate is 0).  Nothing on either path reads a device value
back to the host, so a layer never synchronises the stream.

``ep_a2a`` (expert parallelism over a device mesh) is not ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .common import dense_init

_EP_LATER = ("moe impl 'ep_a2a' (expert parallelism with all-to-all "
             "dispatch) is not ported yet; it comes with distribution "
             "(ROADMAP.md section 1, item 7)")


def init_moe(generator: torch.Generator, cfg: ModelConfig, dtype,
             device) -> dict:
    """Router (f32), per-expert SwiGLU weights (E, d, ff) / (E, ff, d) and,
    when the config has shared experts, their fused SwiGLU under
    ``"shared"``."""
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {"router": dense_init(generator, d, E, torch.float32, device),
         "w_gate": _expert_init(generator, E, d, ff, dtype, device),
         "w_up": _expert_init(generator, E, d, ff, dtype, device),
         "w_down": _expert_init(generator, E, ff, d, dtype, device)}
    if cfg.n_shared_experts:
        sff = cfg.moe_d_ff * cfg.n_shared_experts
        p["shared"] = {"w_gate": dense_init(generator, d, sff, dtype, device),
                       "w_up": dense_init(generator, d, sff, dtype, device),
                       "w_down": dense_init(generator, sff, d, dtype, device)}
    return p


def _expert_init(generator, E: int, d_in: int, d_out: int, dtype,
                 device) -> torch.Tensor:
    w = torch.randn((E, d_in, d_out), generator=generator,
                    dtype=torch.float32, device=device)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def _route(x2d: torch.Tensor, router: torch.Tensor, top_k: int):
    """x2d (N, d) → gates (N, k) f32 renormalised, idx (N, k) int64, probs
    (N, E) f32."""
    probs = torch.softmax(x2d.float() @ router.float(), dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, idx, probs


def aux_load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                          E: int) -> torch.Tensor:
    """Switch-style load-balancing loss of the training step: E times the
    sum over experts of the mean router probability and the share of
    tokens whose top-1 choice is that expert.  probs (N, E) and idx (N, k)
    as :func:`moe_forward` returns them, flattened over tokens."""
    me = probs.mean(0)
    ce = (idx[:, :1] == torch.arange(E, device=idx.device)).float().mean(0)
    return E * (me * ce).sum()


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: ``n·k/E·capacity_factor`` rounded up to 8, at
    least 8."""
    c = int(n_tokens * cfg.moe_top_k / max(cfg.n_experts, 1)
            * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def _shared_forward(sp, x2: torch.Tensor) -> torch.Tensor:
    h = F.silu(x2 @ sp["w_gate"]) * (x2 @ sp["w_up"])
    return h @ sp["w_down"]


def moe_dense(params, x: torch.Tensor, cfg: ModelConfig):
    """Every expert on every token.  x (B,S,d) → (y (B,S,d), (probs,
    idx))."""
    B, S, d = x.shape
    x2 = x.reshape(-1, d)
    gates, idx, probs = _route(x2, params["router"], cfg.moe_top_k)
    h = torch.einsum("nd,edf->enf", x2, params["w_gate"])
    u = torch.einsum("nd,edf->enf", x2, params["w_up"])
    y_all = torch.einsum("enf,efd->end", F.silu(h) * u, params["w_down"])
    experts = torch.arange(cfg.n_experts, device=x.device)
    combine = ((idx[..., None] == experts).float()
               * gates[..., None]).sum(1)                       # (N, E)
    y = torch.einsum("end,ne->nd", y_all.float(), combine).to(x.dtype)
    if params.get("shared") is not None:
        y = y + _shared_forward(params["shared"], x2)
    return y.reshape(B, S, d), (probs, idx)


def moe_dropping(params, x: torch.Tensor, cfg: ModelConfig):
    """Capacity dispatch.  x (B,S,d) → (y (B,S,d), (probs, idx)).  The
    (token, choice) pairs are ranked within their expert in token-major
    order over all B·S rows (padding included), as in the JAX package; a
    pair ranked at or past the capacity is dropped."""
    B, S, d = x.shape
    N = B * S
    E, k = cfg.n_experts, cfg.moe_top_k
    C = _capacity(N, cfg)
    x2 = x.reshape(N, d)
    gates, idx, probs = _route(x2, params["router"], k)

    flat_e = idx.reshape(-1)                                    # (N·k,)
    experts = torch.arange(E, device=x.device)
    onehot = (flat_e[:, None] == experts[None]).to(torch.int32)
    pos_in_e = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    pos = pos_in_e.gather(1, flat_e[:, None])[:, 0]
    keep = pos < C
    gates_flat = gates.reshape(-1) * keep.float()

    # scatter the kept pairs into (E, C, d); a dropped pair adds 0 to slot
    # C - 1, so every buffer row sums one real token at most
    safe_pos = torch.where(keep, pos, C - 1).long()
    slot = flat_e * C + safe_pos
    xk = x2.repeat_interleave(k, dim=0)
    contrib = torch.where(keep[:, None], xk, torch.zeros_like(xk))
    buf = torch.zeros((E * C, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, slot, contrib)
    buf = buf.view(E, C, d)

    h = torch.bmm(buf, params["w_gate"])
    u = torch.bmm(buf, params["w_up"])
    y_buf = torch.bmm(F.silu(h) * u, params["w_down"]).view(E * C, d)

    y_tok = y_buf[slot].float() * gates_flat[:, None]           # (N·k, d)
    y = y_tok.view(N, k, d).sum(1).to(x.dtype)
    if params.get("shared") is not None:
        y = y + _shared_forward(params["shared"], x2)
    return y.reshape(B, S, d), (probs, idx)


def moe_forward(params, x: torch.Tensor, cfg: ModelConfig,
                impl: str = "dropping"):
    """The MoE layer by ``impl`` (``dense`` or ``dropping``).  Returns (y,
    (probs, idx))."""
    if impl == "dense":
        return moe_dense(params, x, cfg)
    if impl == "dropping":
        return moe_dropping(params, x, cfg)
    if impl == "ep_a2a":
        raise NotImplementedError(_EP_LATER)
    raise ValueError(f"unknown moe impl {impl!r}")
