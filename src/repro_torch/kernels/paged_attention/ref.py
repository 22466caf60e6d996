"""Plain PyTorch versions of the paged-attention kernel.

``paged_attention_ref`` gathers the pages into a contiguous (B, T, K, hd)
cache and runs dense masked attention in f32, as the JAX oracle does
(``repro/kernels/paged_attention/ref.py``); the wrapper's ``impl="plain"``
and the CPU path use it.  ``paged_attention_split_ref`` and
``merge_partials_ref`` spell out the CUDA kernel's two passes: partial
softmax states per partition of the sequence in the log2 domain, then their
merge.  ``paged_attention_tiled_ref`` walks each partition in token tiles and
rounds P to bf16 as the bf16 tensor-core kernels (grouped and MLA) do, or
splits every product into three TF32 products as the f32 MLA kernel does, so
each tensor-core kernel can be held to it element by element."""

from __future__ import annotations

import math

import torch

from ..flash_attention.ref import einsum_tf32

NEG_INF = torch.finfo(torch.float32).min


def gather_pages(pages, block_table):
    """pages (P, page, K, hd), or any strided view of that shape;
    block_table (B, n) → (B, n·page, K, hd)."""
    g = pages[block_table.long()]                # (B, n, page, K, hd)
    B, n, page, K, hd = g.shape
    return g.reshape(B, n * page, K, hd)


def paged_attention_ref(q, k_pages, v_pages, block_table, seq_lens, *,
                        scale: float | None = None):
    """q (B,H,hd); k_pages (P,page,K,hd), v_pages (P,page,K,hd_v);
    block_table (B,max_pages); seq_lens (B,) → (B,H,hd_v).  Positions >=
    seq_len are masked; the scale defaults to hd^-0.5."""
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
    Returns f32 ``m`` (B,H,n), ``l`` (B,H,n), ``o`` (B,H,n,hd_v), n
    covering the table's width; an empty partition has m = -inf, l = 0,
    o = 0."""
    B, H, hd = q.shape
    K = k_pages.shape[2]
    hd_v = v_pages.shape[3]
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
    v = v.repeat_interleave(G, dim=2).reshape(B, n, partition, H, hd_v)
    s = torch.einsum("bhd,bnthd->bhnt", q.float(), k) * (scale * math.log2(math.e))
    pos = torch.arange(n * partition, device=q.device).reshape(n, partition)
    mask = pos[None] < seq_lens.to(q.device).long()[:, None, None]  # (B,n,t)
    s = s.masked_fill(~mask[:, None], -math.inf)
    m = s.amax(-1)
    mu = torch.where(m == -math.inf, 0.0, m)
    p = torch.exp2(s - mu[..., None])                  # masked -> 0
    return m, p.sum(-1), torch.einsum("bhnt,bnthd->bhnd", p, v)


def paged_attention_tiled_ref(q, k_pages, v_pages, block_table, seq_lens, *,
                              partition: int, tile: int = 32,
                              scale: float | None = None,
                              round_p: bool = True, tf32_products: int = 0):
    """Same layout and result as :func:`paged_attention_ref`, computed as the
    tensor-core kernels do, for any group G, key width and value width
    (values from pages of their own, or a view of the key rows): each
    partition of ``partition`` tokens is walked in ``tile``-token tiles
    keeping a running max (over the whole tile) and sum per head, scores
    scaled by ``scale · log2(e)`` after the product and exponentiated with
    exp2, products accumulated in f32; the partitions' states then merge as
    :func:`merge_partials_ref` does.  The bf16 kernels
    (``paged_gqa_mma_kernel`` at G >= 2, ``paged_mla_mma_kernel``): P
    rounded to bf16 before P·V when ``round_p`` (the sum takes P
    unrounded).  The f32 MLA kernel
    (``paged_mla_tf32x3_kernel``; ``tf32_products=3``, ``round_p=False``):
    Q·Kᵀ and P·V each as three TF32 products of split operands
    (``einsum_tf32``), the sums taken on P unsplit; ``tf32_products=1`` is
    the single TF32 product the kernel never runs.  Returns (B,H,hd_v) in
    q's dtype."""
    if tf32_products not in (0, 1, 3):
        raise ValueError(f"tf32_products must be 0, 1 or 3, got "
                         f"{tf32_products}")
    if tf32_products and round_p:
        raise ValueError("P is rounded to bf16 or split into TF32, not both")
    B, H, hd = q.shape
    K = k_pages.shape[2]
    hd_v = v_pages.shape[3]
    G = H // K
    scale = hd ** -0.5 if scale is None else scale
    k = gather_pages(k_pages, block_table).float()       # (B,T,K,hd)
    v = gather_pages(v_pages, block_table).float()
    T = k.shape[1]
    n = max(1, -(-T // partition))
    nt = -(-partition // tile)                           # tiles a partition
    dev = q.device
    step = torch.arange(nt, device=dev)[:, None] * tile + torch.arange(
        tile, device=dev)[None]                          # (nt, tile)
    pos = torch.arange(n, device=dev)[:, None, None] * partition + step
    valid = ((step < partition)[None, None]
             & (pos[None] < seq_lens.to(dev).long()[:, None, None, None]))
    idx = pos.clamp_max(T - 1)
    kt, vt = k[:, idx], v[:, idx]                # (B, n, nt, tile, K, hd)
    qf = q.float().reshape(B, K, G, hd)
    m = torch.full((B, K, G, n), -math.inf, device=dev)
    l = torch.zeros((B, K, G, n), device=dev)
    o = torch.zeros((B, K, G, n, hd_v), device=dev)
    for j in range(nt):
        s = einsum_tf32("bkgd,bntkd->bkgnt", qf, kt[:, :, j], tf32_products)
        s = s * (scale * math.log2(math.e))
        s = s.masked_fill(~valid[:, None, None, :, j], -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        mu = torch.where(m_new == -math.inf, 0.0, m_new)  # no token seen yet
        corr = torch.exp2(m - mu)
        p = torch.exp2(s - mu[..., None])
        l = l * corr + p.sum(-1)
        if round_p:
            p = p.to(torch.bfloat16).float()
        o = o * corr[..., None] + einsum_tf32("bkgnt,bntkd->bkgnd", p,
                                              vt[:, :, j], tf32_products)
        m = m_new
    return merge_partials_ref(m.reshape(B, H, n), l.reshape(B, H, n),
                              o.reshape(B, H, n, hd_v), dtype=q.dtype)


def combine_partials_ref(m, l, o):
    """The merge pass's sums before its division: the n partials' states
    m, l (B,H,n), o (B,H,n,hd_v) as the state of one partition, M = max mᵢ,
    L = Σ 2^(mᵢ-M)·lᵢ and O = Σ 2^(mᵢ-M)·oᵢ over the non-empty partials,
    shaped (B,H,1) and (B,H,1,hd_v); m = -inf, l = 0, o = 0 where no
    partition held a token."""
    M = m.amax(-1, keepdim=True)
    wt = torch.where(m == -math.inf, 0.0,
                     torch.exp2(m - torch.where(M == -math.inf, 0.0, M)))
    return (M, (l * wt).sum(-1, keepdim=True),
            (o * wt[..., None]).sum(-2, keepdim=True))


def merge_partials_ref(m, l, o, dtype=torch.float32):
    """The merge pass: Σ 2^(mᵢ-M)·oᵢ / Σ 2^(mᵢ-M)·lᵢ over the non-empty
    partials (M = max mᵢ); 0 where no partition held a token.  m, l (B,H,n),
    o (B,H,n,hd_v) → (B,H,hd_v) in ``dtype``."""
    _, L, O = combine_partials_ref(m, l, o)
    L, O = L[..., 0], O[..., 0, :]
    out = torch.where(L[..., None] > 0, O / L.clamp_min(1e-30)[..., None], 0.0)
    return out.to(dtype)
