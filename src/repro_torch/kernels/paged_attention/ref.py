"""Plain PyTorch versions of the paged-attention kernel.

``paged_attention_ref`` gathers the pages into a contiguous (B, T, K, hd)
cache and runs dense masked attention in f32, as the JAX oracle does
(``repro/kernels/paged_attention/ref.py``); the wrapper's ``impl="plain"``
and the CPU path use it.  ``paged_attention_split_ref`` and
``merge_partials_ref`` spell out the CUDA kernel's two passes: partial
softmax states per partition of the sequence in the log2 domain, then their
merge."""

from __future__ import annotations

import math

import torch

NEG_INF = torch.finfo(torch.float32).min


def gather_pages(pages, block_table):
    """pages (P, page, K, hd); block_table (B, n) → (B, n·page, K, hd)."""
    g = pages[block_table.long()]                # (B, n, page, K, hd)
    B, n, page, K, hd = g.shape
    return g.reshape(B, n * page, K, hd)


def paged_attention_ref(q, k_pages, v_pages, block_table, seq_lens, *,
                        scale: float | None = None):
    """q (B,H,hd); k/v_pages (P,page,K,hd); block_table (B,max_pages);
    seq_lens (B,) → (B,H,hd).  Positions >= seq_len are masked."""
    B, H, hd = q.shape
    K = k_pages.shape[2]
    G = H // K
    scale = hd ** -0.5 if scale is None else scale
    k = gather_pages(k_pages, block_table)       # (B,T,K,hd)
    v = gather_pages(v_pages, block_table)
    T = k.shape[1]
    kk = k.repeat_interleave(G, dim=2)
    vv = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bhd,bthd->bht", q.float(), kk.float()) * scale
    pos = torch.arange(T, device=q.device)[None, :]
    mask = pos < seq_lens.to(q.device).long()[:, None]
    s = s.masked_fill(~mask[:, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bht,bthd->bhd", p, vv.float())
    return out.to(q.dtype)


def paged_attention_split_ref(q, k_pages, v_pages, block_table, seq_lens, *,
                              partition: int = 256,
                              scale: float | None = None):
    """The split pass: per (sequence, query head, partition of ``partition``
    tokens) the max ``m`` and sum ``l`` of the masked scores in the log2
    domain (``score · scale · log2(e)``) and the unnormalised output ``o``.
    Returns f32 ``m`` (B,H,n), ``l`` (B,H,n), ``o`` (B,H,n,hd), n covering
    the table's width; an empty partition has m = -inf, l = 0, o = 0."""
    B, H, hd = q.shape
    K = k_pages.shape[2]
    G = H // K
    scale = hd ** -0.5 if scale is None else scale
    k = gather_pages(k_pages, block_table).float()       # (B,T,K,hd)
    v = gather_pages(v_pages, block_table).float()
    T = k.shape[1]
    n = max(1, -(-T // partition))
    pad = n * partition - T
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    k = k.repeat_interleave(G, dim=2).reshape(B, n, partition, H, hd)
    v = v.repeat_interleave(G, dim=2).reshape(B, n, partition, H, hd)
    s = torch.einsum("bhd,bnthd->bhnt", q.float(), k) * (scale * math.log2(math.e))
    pos = torch.arange(n * partition, device=q.device).reshape(n, partition)
    mask = pos[None] < seq_lens.to(q.device).long()[:, None, None]  # (B,n,t)
    s = s.masked_fill(~mask[:, None], -math.inf)
    m = s.amax(-1)
    mu = torch.where(m == -math.inf, 0.0, m)
    p = torch.exp2(s - mu[..., None])                  # masked -> 0
    return m, p.sum(-1), torch.einsum("bhnt,bnthd->bhnd", p, v)


def merge_partials_ref(m, l, o, dtype=torch.float32):
    """The merge pass: Σ 2^(mᵢ-M)·oᵢ / Σ 2^(mᵢ-M)·lᵢ over the non-empty
    partials (M = max mᵢ); 0 where no partition held a token.  m, l (B,H,n),
    o (B,H,n,hd) → (B,H,hd) in ``dtype``."""
    M = m.amax(-1, keepdim=True)
    wt = torch.where(m == -math.inf, 0.0,
                     torch.exp2(m - torch.where(M == -math.inf, 0.0, M)))
    L = (l * wt).sum(-1)
    O = (o * wt[..., None]).sum(-2)
    out = torch.where(L[..., None] > 0, O / L.clamp_min(1e-30)[..., None], 0.0)
    return out.to(dtype)
