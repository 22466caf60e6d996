"""Plain PyTorch version of the paged-attention kernel: gathers the pages
into a contiguous (B, T, K, hd) cache and runs dense masked attention in f32,
as the JAX oracle does (``repro/kernels/paged_attention/ref.py``)."""

from __future__ import annotations

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
