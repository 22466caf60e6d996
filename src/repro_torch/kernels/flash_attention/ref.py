"""Plain PyTorch versions of the flash-attention kernel.

``flash_attention_ref`` is a dense masked softmax in f32 with the GQA /
causal / window semantics of the JAX oracle
(``repro/kernels/flash_attention/ref.py``); the wrapper's ``impl="plain"``
and the CPU path use it.  ``flash_attention_tiled_ref`` spells out the bf16
tensor-core kernel's arithmetic: 64-key tiles, an online softmax in the
log2 domain, and P rounded to bf16 before the P·V product.

Both take the kernel's query offset and visible-key count: query row i
stands at absolute position ``q_offset + i`` and only the first ``kv_len``
keys exist (the rest of k and v, e.g. the unused tail of a slot cache, is
never read).  Values may be narrower than queries and keys (MLA prefill:
hd 192, hd_v 128)."""

from __future__ import annotations

import math

import torch

NEG_INF = torch.finfo(torch.float32).min


def _visible(k, v, kv_len):
    """k and v cut to their first ``kv_len`` keys (all when None)."""
    T = k.shape[2] if kv_len is None else kv_len
    if not 0 <= T <= k.shape[2]:
        raise ValueError(f"kv_len {kv_len} outside [0, {k.shape[2]}]")
    return k[:, :, :T], v[:, :, :T], T


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: float | None = None, q_offset: int = 0,
                        kv_len: int | None = None):
    """q (B,H,S,hd); k (B,K,T,hd), v (B,K,T,hd_v) → (B,H,S,hd_v).  Query
    head h reads KV head h // (H/K); query row i stands at position
    ``q_offset + i`` and sees the first ``kv_len`` keys (default T).  A row
    with no visible key gives 0.  The scale defaults to hd^-0.5."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    k, v, T = _visible(k, v, kv_len)
    G = H // K
    scale = hd ** -0.5 if scale is None else scale
    kk = k.repeat_interleave(G, dim=1)
    vv = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kk.float()) * scale
    q_pos = q_offset + torch.arange(S, device=q.device)[:, None]
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


def flash_attention_tiled_ref(q, k, v, *, causal: bool = True,
                              window: int = 0, scale: float | None = None,
                              q_offset: int = 0, kv_len: int | None = None,
                              tile: int = 64, round_p: bool = True):
    """Same layout and semantics as :func:`flash_attention_ref`, computed as
    the bf16 kernel does: walk the keys in ``tile``-key tiles keeping a
    running max and sum per row, scores scaled by ``scale · log2(e)`` and
    exponentiated with exp2, P rounded to bf16 before P·V when
    ``round_p``, products accumulated in f32."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    k, v, T = _visible(k, v, kv_len)
    G = H // K
    scale = hd ** -0.5 if scale is None else scale
    qf = q.float()
    kk = k.repeat_interleave(G, dim=1).float()
    vv = v.repeat_interleave(G, dim=1).float()
    q_pos = q_offset + torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, H, S), -math.inf, device=q.device)
    l = torch.zeros((B, H, S), device=q.device)
    acc = torch.zeros((B, H, S, v.shape[-1]), device=q.device)
    for k0 in range(0, T, tile):
        s = torch.einsum("bhsd,bhtd->bhst", qf, kk[:, :, k0:k0 + tile])
        s = s * (scale * math.log2(math.e))
        k_pos = torch.arange(k0, min(k0 + tile, T), device=q.device)[None, :]
        mask = torch.ones((S, k_pos.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= k_pos <= q_pos
        if window and window > 0:
            mask &= k_pos > q_pos - window
        s = s.masked_fill(~mask, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        mu = torch.where(m_new == -math.inf, 0.0, m_new)   # no key seen yet
        corr = torch.exp2(m - mu)
        p = torch.exp2(s - mu[..., None])
        l = l * corr + p.sum(-1)
        if round_p:
            p = p.to(torch.bfloat16).float()
        acc = acc * corr[..., None] + torch.einsum(
            "bhst,bhtd->bhsd", p, vv[:, :, k0:k0 + tile])
        m = m_new
    out = torch.where(l[..., None] > 0, acc / l.clamp_min(1e-30)[..., None],
                      0.0)
    return out.to(q.dtype)
