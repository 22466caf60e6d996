"""Plain PyTorch versions of the flash-attention kernel.

``flash_attention_ref`` is a dense masked softmax in f32 with the GQA /
causal / window semantics of the JAX oracle
(``repro/kernels/flash_attention/ref.py``); the wrapper's ``impl="plain"``
and the CPU path use it.  ``flash_attention_tiled_ref`` spells out the
tensor-core kernels' arithmetic: key tiles, an online softmax in the log2
domain, and either P rounded to bf16 before the P·V product (the bf16
kernel) or every product taken as three TF32 products of split operands
(the f32 kernel; ``split_tf32`` splits as it does).

Both take the kernel's query offset and visible-key count: query row i
stands at absolute position ``q_offset + i`` and only the first ``kv_len``
keys exist (the rest of k and v, e.g. the unused tail of a slot cache, is
never read).  Values may be narrower than queries and keys (MLA prefill:
hd 192, hd_v 128)."""

from __future__ import annotations

import math

import numpy as np
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


def tf32_rna(x):
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties
    away from zero, on 10 explicit mantissa bits, by integer operations on
    the bits (adding half a TF32 ulp to the magnitude, then clearing the low
    13 bits), as the f32 kernel does.  Infinities stay infinite."""
    bits = x.float().contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def split_tf32(x):
    """``x`` as ``(big, small)``: ``big = tf32_rna(x)``, and ``small = x -
    big`` (exact in f32) truncated to TF32 (its low 13 bits cleared), the f32
    kernel's split of every operand (``csrc/warp_mma.cuh::split_tf32``).
    ``big + small`` holds x to within 2^-21 of it."""
    big = tf32_rna(x)
    rest = (x.float() - big).contiguous().view(torch.int32)
    return big, torch.bitwise_and(rest, -0x2000).view(torch.float32)


def einsum_tf32(eq, a, b, tf32_products):
    """``einsum(eq, a, b)`` in f32 as the f32 kernels take it: in f32 (0),
    as one TF32 product (1) or as three TF32 products of the split operands
    (3: big·big + big·small + small·big, small·small dropped)."""
    if tf32_products == 0:
        return torch.einsum(eq, a, b)
    (ab, as_), (bb, bs) = split_tf32(a), split_tf32(b)
    if tf32_products == 1:
        return torch.einsum(eq, ab, bb)
    return (torch.einsum(eq, as_, bb) + torch.einsum(eq, ab, bs)
            + torch.einsum(eq, ab, bb))


def flash_attention_tiled_ref(q, k, v, *, causal: bool = True,
                              window: int = 0, scale: float | None = None,
                              q_offset: int = 0, kv_len: int | None = None,
                              tile: int = 64, round_p: bool = True,
                              tf32_products: int = 0):
    """Same layout and semantics as :func:`flash_attention_ref`, computed as
    the tensor-core kernels do: walk the keys in ``tile``-key tiles keeping
    a running max and sum per row, scores left unscaled and then scaled by
    ``scale · log2(e)`` (the f32 product of the f32 scale and log2(e)) and
    exponentiated with exp2, products accumulated in f32.  The bf16
    kernel: P rounded to bf16 before P·V when ``round_p``; on CUDA bf16
    inputs, the scores taken on the tensor cores as the kernel takes them.
    The f32 kernel (``tf32_products=3``, ``round_p=False``, the tile of
    ``ops.F32_KV_TILE``): Q·Kᵀ and P·V each as three TF32 products of split
    operands, the row sums taken on P unsplit; ``tf32_products=1`` is the
    single TF32 product the kernel never runs."""
    if tf32_products not in (0, 1, 3):
        raise ValueError(f"tf32_products must be 0, 1 or 3, got "
                         f"{tf32_products}")
    if tf32_products and round_p:
        raise ValueError("P is rounded to bf16 or split into TF32, not both")
    B, H, S, hd = q.shape
    K = k.shape[1]
    k, v, T = _visible(k, v, kv_len)
    G = H // K
    scale = hd ** -0.5 if scale is None else scale
    qf = q.float()
    kk = k.repeat_interleave(G, dim=1).float()
    vv = v.repeat_interleave(G, dim=1).float()
    # bf16 on the card: the scores as the bf16 kernel takes them, a bf16
    # tensor-core product with f32 accumulation.  A sum of f32 products on
    # the CUDA cores parts from it by enough, now and then, to round a P of a
    # row with few keys to the other bf16 neighbour (PERF.md section 6).
    tc = (q.is_cuda and q.dtype == torch.bfloat16 and k.dtype == torch.bfloat16
          and round_p and not tf32_products)
    kb = k.repeat_interleave(G, dim=1) if tc else None
    q_pos = q_offset + torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, H, S), -math.inf, device=q.device)
    l = torch.zeros((B, H, S), device=q.device)
    acc = torch.zeros((B, H, S, v.shape[-1]), device=q.device)
    # scale · log2(e) as the kernels take it: the f32 product of the f32
    # scale and the f32 log2(e)
    c = float(np.float32(scale) * np.float32(math.log2(math.e)))
    for k0 in range(0, T, tile):
        if tc:
            kt = kb[:, :, k0:k0 + tile]
            s = torch.bmm(q.reshape(B * H, S, hd),
                          kt.reshape(B * H, -1, hd).transpose(1, 2),
                          out_dtype=torch.float32).view(B, H, S, -1)
        else:
            s = einsum_tf32("bhsd,bhtd->bhst", qf, kk[:, :, k0:k0 + tile],
                            tf32_products)
        s = s * c
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
        acc = acc * corr[..., None] + einsum_tf32(
            "bhst,bhtd->bhsd", p, vv[:, :, k0:k0 + tile], tf32_products)
        m = m_new
    out = torch.where(l[..., None] > 0, acc / l.clamp_min(1e-30)[..., None],
                      0.0)
    return out.to(q.dtype)
