"""Blockwise (memory-efficient, FlashAttention-algorithm) attention in torch
ops: the training attention above ``attention.BLOCKWISE_THRESHOLD`` tokens,
ported from the JAX package's ``models/blockwise.py``.

The dense path materializes (B, H, S, T) scores; this one runs the online
softmax block algorithm so that the working set is one query block's scores:

  * an outer loop over query blocks, each under
    ``torch.utils.checkpoint`` (non-reentrant), so that the backward keeps
    one block's output and recomputes its scores, as JAX checkpoints its
    query-block function;
  * per query block a *banded* KV slice ending at the block's last query:
    ``window + block_q`` keys for windowed causal attention (local and
    sliding-window layers never touch the whole sequence), the whole
    sequence otherwise (blocks above the diagonal are computed and masked,
    as in JAX);
  * an inner loop over KV blocks with the (m, l, acc) online-softmax carry
    in f32; scores are taken in f32 from the compute-dtype operands (JAX's
    ``preferred_element_type``), P is cast to ``v``'s dtype before P·V.

No kernel wrapper is called: autograd differentiates these ops.  The JAX
module's ``REPRO_BLOCKWISE_OPT`` and ``REPRO_BLOCKWISE_BF16`` switches
(sharding experiments for a TPU mesh, off by default) are not ported.
"""

from __future__ import annotations

from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from .common import attention_mask

NEG_INF = float(torch.finfo(torch.float32).min)


def _q_block(qi, k_sl, v_sl, *, q_start: int, kv_start: int, block_kv: int,
             scale: float, causal: bool, window: int, out_dtype):
    """One query block qi (B,K,G,bq,hd) over its KV slice k_sl/v_sl
    (B,span,K,·).  Returns (B,K,G,bq,vd) in ``out_dtype``."""
    B, K, G, bq, hd = qi.shape
    span, vd = k_sl.shape[1], v_sl.shape[-1]
    nkv = span // block_kv
    kb = k_sl.reshape(B, nkv, block_kv, K, hd).permute(1, 0, 3, 2, 4)
    vb = v_sl.reshape(B, nkv, block_kv, K, vd).permute(1, 0, 3, 2, 4)
    q32 = qi.float().reshape(B, K, G * bq, hd)
    m = torch.full((B, K, G, bq), NEG_INF, dtype=torch.float32,
                   device=qi.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, K, G, bq, vd), dtype=torch.float32,
                      device=qi.device)
    for j in range(nkv):
        kj, vj = kb[j], vb[j]                        # (B,K,bkv,·)
        scores = (q32 @ kj.float().transpose(-1, -2)).view(
            B, K, G, bq, block_kv) * scale
        # the mask depends on q_pos - k_pos only: keys of block j from 0
        mask = attention_mask(bq, block_kv, causal=causal, window=window,
                              q_offset=q_start - kv_start - j * block_kv,
                              device=qi.device)
        scores = torch.where(mask, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        l = l * corr + p.sum(-1)
        pv = p.to(vj.dtype).reshape(B, K, G * bq, block_kv) @ vj
        acc = acc * corr[..., None] + pv.view(B, K, G, bq, vd).float()
        m = m_new
    out = acc / l[..., None].clamp_min(1e-30)
    return out.to(out_dtype)


def blockwise_gqa_attend(q, k, v, *, causal: bool, window: int = 0,
                         q_offset: int = 0, block_q: int = 512,
                         block_kv: int = 1024, scale: float | None = None):
    """q (B,S,H,hd); k (B,T,K,hd), v (B,T,K,vd) with H = K·G.  Returns
    (B, S, H·vd) in q's dtype.

    ``window`` > 0 bounds attention to the last ``window`` positions; 0 is
    unbounded.  ``q_offset`` is the absolute position of q[0].  Block sizes
    are halved until they divide S and the KV span.  A query row with no
    visible key gives 0."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = hd ** -0.5 if scale is None else scale

    block_q = min(block_q, S)
    while S % block_q:
        block_q //= 2
    nq = S // block_q
    span = window + block_q if causal and window and window > 0 else T
    span = min(span, T)
    block_kv = min(block_kv, span)
    while span % block_kv:
        block_kv //= 2

    qb = q.reshape(B, nq, block_q, K, G, hd).permute(1, 0, 3, 4, 2, 5)
    outs = []
    for idx in range(nq):
        q_start = q_offset + idx * block_q
        kv_start = (0 if span == T else
                    min(max(q_start + block_q - span, 0), T - span))
        fn = partial(_q_block, q_start=q_start, kv_start=kv_start,
                     block_kv=block_kv, scale=scale, causal=causal,
                     window=window, out_dtype=q.dtype)
        outs.append(checkpoint(fn, qb[idx], k[:, kv_start:kv_start + span],
                               v[:, kv_start:kv_start + span],
                               use_reentrant=False))
    out = torch.stack(outs)                          # (nq,B,K,G,bq,vd)
    return out.permute(1, 0, 4, 2, 3, 5).reshape(B, S, -1)


def reference_attend(q, k, v, *, causal: bool, window: int = 0,
                     q_offset: int = 0):
    """Dense oracle with the same GQA semantics (the JAX package's
    ``reference_attend``): scores in the operands' dtype, softmax in f32, a
    row with no visible key 0 (JAX broadcasts that row test against the key
    axis, which agrees where every row sees a key).  Returns (B, S, H·hd)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, K, H // K, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k) * hd ** -0.5
    mask = attention_mask(S, T, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    scores = torch.where(mask, scores.float(), NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(-1)[:, None], probs, 0.0)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype), v)
    return out.reshape(B, S, H * hd)
