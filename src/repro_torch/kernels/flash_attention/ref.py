"""Plain PyTorch version of the flash-attention kernel: dense masked softmax
in f32 with the GQA / causal / window semantics of the JAX oracle
(``repro/kernels/flash_attention/ref.py``)."""

from __future__ import annotations

import torch

NEG_INF = torch.finfo(torch.float32).min


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: float | None = None):
    """q (B,H,S,hd); k/v (B,K,T,hd) → (B,H,S,hd).  Query head h reads KV
    head h // (H/K).  A row with no visible key gives 0."""
    B, H, S, hd = q.shape
    K, T = k.shape[1], k.shape[2]
    G = H // K
    scale = hd ** -0.5 if scale is None else scale
    kk = k.repeat_interleave(G, dim=1)
    vv = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kk.float()) * scale
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window and window > 0:
        mask &= k_pos > q_pos - window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[None, None, :, None], p, 0.0)
    out = torch.einsum("bhst,bhtd->bhsd", p, vv.float())
    return out.to(q.dtype)
