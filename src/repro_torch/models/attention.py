"""Attention for the ported architectures: GQA/MHA/MQA with RoPE and the
optional qwen3 ``qk_norm``.

Prefill goes through the flash-attention kernel wrapper for every sequence
length, decode through the paged-attention kernel wrapper; on CPU tensors
both run their plain PyTorch versions.  Shapes: x (B, S, d); a layer's
decode cache is ``{"k", "v"}`` of (B, S_max, K, hd), updated **in place** by
:func:`gqa_decode` (the JAX package returns new caches instead).

Not ported yet, and raising ``NotImplementedError``: MLA (deepseek-v2-lite,
minicpm3), the sliding-window ring cache (h2o-danube, gemma3 local layers)
and the chunked-prefill path (``gqa_chunk_decode``).
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.paged_attention.ops import paged_attention
from .common import apply_rope, dense_init, rms_norm

DECODE_PAGE = 16   # tokens per page when a slot cache is viewed as a page pool

_MLA_LATER = ("MLA attention is not ported yet; it comes with the later step "
              "that brings MLA, MoE, ring/SWA, RG-LRU and SSM")
_RING_LATER = ("sliding-window (ring-cache) decode is not ported yet; it comes "
               "with the later step that brings MLA, MoE, ring/SWA, RG-LRU "
               "and SSM")


def init_attention(generator: torch.Generator, cfg: ModelConfig, dtype,
                   device) -> dict:
    """Projection weights (and qk-norm scales) of one GQA layer."""
    if cfg.use_mla:
        raise NotImplementedError(_MLA_LATER)
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": dense_init(generator, d, H * hd, dtype, device),
         "wk": dense_init(generator, d, K * hd, dtype, device),
         "wv": dense_init(generator, d, K * hd, dtype, device),
         "wo": dense_init(generator, H * hd, d, dtype, device)}
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
    return p


def _qkv(params, x, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, S, H, hd)
    k = (x @ params["wk"]).reshape(B, S, K, hd)
    v = (x @ params["wv"]).reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v.contiguous()


def gqa_forward(params, x, cfg: ModelConfig, *, window: int, positions,
                causal: bool = True, return_kv: bool = False,
                impl: str | None = None):
    """Full-sequence attention (prefill).  x (B,S,d) → (B,S,d), plus the
    layer's ``{"k", "v"}`` (B,S,K,hd) when ``return_kv``.  The flash kernel
    serves every S, so the JAX package's blockwise branch above 2048 tokens
    has no counterpart."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg, positions)
    out = flash_attention(q, k, v, causal=causal, window=window, impl=impl)
    y = out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ params["wo"]
    if return_kv:
        return y, {"k": k, "v": v}
    return y


def _pos_vec(cache_pos, B: int, device) -> torch.Tensor:
    """Normalize cache_pos (an int, or a (B,) vector of per-row positions)
    to a (B,) int64 tensor on ``device``."""
    p = torch.as_tensor(cache_pos, device=device).long()
    return p.expand(B) if p.dim() == 0 else p


@lru_cache(maxsize=16)
def _slot_block_table(n_slots: int, pages_per_slot: int,
                      device: torch.device) -> torch.Tensor:
    """Block table of a slot cache viewed as a page pool: row b names pages
    ``b·pages_per_slot .. (b+1)·pages_per_slot - 1`` (no copy needed)."""
    base = torch.arange(n_slots, dtype=torch.int32, device=device)[:, None]
    offs = torch.arange(pages_per_slot, dtype=torch.int32, device=device)[None]
    return (base * pages_per_slot + offs).contiguous()


def gqa_decode(params, x, cache: dict, cache_pos, cfg: ModelConfig,
               *, window: int, impl: str | None = None):
    """Single-token decode.  x (B,1,d); cache k/v (B,S_max,K,hd);
    cache_pos: int or (B,) — tokens already in each row's cache (< S_max).

    Writes the new token's K/V into ``cache`` **in place** at each row's
    position, then attends with the paged kernel over the cache viewed as a
    page pool (``seq_lens = cache_pos + 1``, the JAX mask ``k_pos <= pos``).
    Returns (y (B,1,d), cache)."""
    if window and window > 0:
        raise NotImplementedError(_RING_LATER)
    B = x.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    posv = _pos_vec(cache_pos, B, x.device)
    q = (x @ params["wq"]).reshape(B, 1, H, hd)
    k_new = (x @ params["wk"]).reshape(B, 1, K, hd)
    v_new = (x @ params["wv"]).reshape(B, 1, K, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k_new = rms_norm(k_new, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, posv[:, None], cfg.rope_theta)
    k_new = apply_rope(k_new, posv[:, None], cfg.rope_theta)
    rows = torch.arange(B, device=x.device)
    kc, vc = cache["k"], cache["v"]
    kc[rows, posv] = k_new[:, 0].to(kc.dtype)
    vc[rows, posv] = v_new[:, 0].to(vc.dtype)
    n_slots, s_max = kc.shape[:2]
    page = math.gcd(s_max, DECODE_PAGE)
    pages = s_max // page
    kp = kc.view(n_slots * pages, page, K, hd)
    vp = vc.view(n_slots * pages, page, K, hd)
    table = _slot_block_table(n_slots, pages, kc.device)[:B]
    seq_lens = (posv + 1).to(torch.int32)
    out = paged_attention(q[:, 0].to(kc.dtype), kp, vp, table, seq_lens,
                          impl=impl)
    y = out.to(x.dtype).reshape(B, 1, H * hd) @ params["wo"]
    return y, cache


def window_for(cfg: ModelConfig, kind: str) -> int:
    """Attention window of a layer kind (0 = unbounded)."""
    if kind == "local":
        return cfg.window
    if kind == "global":
        return 0
    if cfg.attn_kind == "swa":
        return cfg.window
    return 0


def attn_forward(params, x, cfg: ModelConfig, kind: str, positions,
                 return_kv: bool = False, impl: str | None = None):
    """Prefill attention of a layer of kind ``kind``."""
    if cfg.use_mla:
        raise NotImplementedError(_MLA_LATER)
    return gqa_forward(params, x, cfg, window=window_for(cfg, kind),
                       positions=positions, causal=cfg.causal,
                       return_kv=return_kv, impl=impl)


def attn_decode(params, x, cache, cache_pos, cfg: ModelConfig, kind: str,
                impl: str | None = None):
    """Single-token decode attention of a layer of kind ``kind``."""
    if cfg.use_mla:
        raise NotImplementedError(_MLA_LATER)
    return gqa_decode(params, x, cache, cache_pos, cfg,
                      window=window_for(cfg, kind), impl=impl)
