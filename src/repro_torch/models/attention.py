"""Attention for the ported architectures: GQA/MHA/MQA with RoPE and the
optional qwen3 ``qk_norm``, and MLA (multi-head latent attention,
deepseek-v2-lite).

Prefill and chunked prefill go through the flash-attention kernel wrapper
for every sequence length, decode through the paged-attention kernel
wrapper; on CPU tensors both run their plain PyTorch versions.  The training
forward (``attn_forward(..., train=True)``) never reaches a kernel wrapper:
it runs :func:`gqa_attend` (dense, the JAX package's XLA path) up to
``BLOCKWISE_THRESHOLD`` tokens and ``blockwise.blockwise_gqa_attend`` above,
and for MLA :func:`mla_forward`'s two-term dense scores, or above the
threshold its MHA fold through ``blockwise_gqa_attend``, all in torch ops
that autograd differentiates.  Shapes: x
(B, S, d).  A GQA layer's decode cache is ``{"k", "v"}`` of (B, S_max, K,
hd); an MLA layer's is ``{"ckv"}`` of (B, S_max, 1, r + rd), each row the
compressed latent followed by the rotated rope key.  :func:`gqa_decode`,
:func:`mla_decode`, :func:`gqa_chunk_decode` and :func:`mla_chunk_decode`
update the cache **in place** (the JAX package returns new caches and keeps
MLA's two parts as ``{"latent", "k_rope"}``; ``bridge`` converts).

MLA prefill and chunked prefill fold into MHA form (queries and keys of hd
+ rd, values of vd) for the flash kernel, a chunk's keys and values
decompressed from the resident latent rows; MLA decode is absorbed: the
query is projected through W_uk and attends over the latent cache as one
KV head of r + rd keys whose values are the first r columns of the same
rows, through the paged kernel.

A sliding-window layer (h2o-danube's, gemma3's local ones) decodes over a
*ring* cache ``{"k", "v"}`` of (B, W′, K, hd), W′ = min(window, s_max):
position p lives in slot ``p % W′``, its key stored after RoPE, so
:func:`gqa_decode_ring` hands the ring to the paged kernel as a page pool
with ``seq_lens = min(pos + 1, W′)`` — the slots that hold a position of
the window, in any order — and the kernel needs no window of its own.
:func:`ring_cache_from_prefill` builds each row's ring from the row's true
length (the JAX package keeps the last W positions of the padded length,
which loses real positions and keeps pads once a bucket is longer than the
window).
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch

from ..configs.base import ModelConfig
from ..distributed.spmd import (head_reshape, is_dtensor, local_heads,
                                replicated)
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.paged_attention.ops import (paged_attention,
                                           paged_attention_partials)
from ..kernels.paged_attention.ref import (combine_partials_ref,
                                           merge_partials_ref)
from .blockwise import blockwise_gqa_attend
from .common import apply_rope, attention_mask, dense_init, rms_norm

DECODE_PAGE = 16   # tokens per page when a slot cache is viewed as a page pool
BLOCKWISE_THRESHOLD = 2048   # training attention is blockwise above this S

MLA_CACHE = "ckv"   # an MLA layer's decode cache entry: latent ‖ k_rope

_RING_DECODE = ("a sliding-window layer decodes over its ring cache "
                "(gqa_decode_ring), as the JAX stack routes it; this decode "
                "takes full caches only")
_RING_CHUNK = ("chunked decode is refused for sliding-window layers (a later "
               "chunk token overwrites a ring slot an earlier query of the "
               "chunk still needs), as in the JAX package")


def init_attention(generator: torch.Generator, cfg: ModelConfig, dtype,
                   device) -> dict:
    """Projection weights of one attention layer: GQA (and qk-norm scales),
    or MLA (query, latent down-projection and its norm, rope key, latent
    up-projections to keys and values, output)."""
    if cfg.use_mla:
        return _init_mla(generator, cfg, dtype, device)
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": dense_init(generator, d, H * hd, dtype, device),
         "wk": dense_init(generator, d, K * hd, dtype, device),
         "wv": dense_init(generator, d, K * hd, dtype, device),
         "wo": dense_init(generator, H * hd, d, dtype, device)}
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
    return p


def _init_mla(generator: torch.Generator, cfg: ModelConfig, dtype,
              device) -> dict:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    r, rd, vd = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.v_head_dim
    return {"wq": dense_init(generator, d, H * (hd + rd), dtype, device),
            "w_dkv": dense_init(generator, d, r, dtype, device),
            "w_krope": dense_init(generator, d, rd, dtype, device),
            "w_uk": dense_init(generator, r, H * hd, dtype, device),
            "w_uv": dense_init(generator, r, H * vd, dtype, device),
            "wo": dense_init(generator, H * vd, d, dtype, device),
            "kv_norm": torch.zeros((r,), dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, s_max: int, dtype,
               device) -> dict:
    """Zero decode cache of one attention layer: ``{"k", "v"}`` of (batch,
    s_max, K, hd), or for MLA ``{"ckv"}`` of (batch, s_max, 1, r + rd)."""
    if cfg.use_mla:
        shape = (batch, s_max, 1, cfg.kv_lora_rank + cfg.rope_head_dim)
        return {MLA_CACHE: torch.zeros(shape, dtype=dtype, device=device)}
    shape = (batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _qkv(params, x, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = head_reshape(x @ params["wq"], B, S, H, hd, heads=H)
    k = head_reshape(x @ params["wk"], B, S, K, hd, heads=K)
    v = head_reshape(x @ params["wv"], B, S, K, hd, heads=K)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v.contiguous()


def gqa_attend(q, k, v, mask):
    """Dense GQA attention (the JAX package's ``gqa_attend``): q (B,S,H,hd),
    k/v (B,T,K,hd), mask (S,T) bool.  Scores in the operands' dtype, softmax
    in f32, probabilities cast to v's dtype.  Returns (B, S, H·hd)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k) * hd ** -0.5
    scores = torch.where(mask, scores.float(),
                         torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, S, H * hd)


def gqa_forward(params, x, cfg: ModelConfig, *, window: int, positions,
                causal: bool = True, return_kv: bool = False,
                impl: str | None = None, train: bool = False):
    """Full-sequence attention.  x (B,S,d) → (B,S,d), plus the layer's
    ``{"k", "v"}`` (B,S,K,hd) when ``return_kv``.  Prefill runs the flash
    kernel for every S; the training forward (``train``) runs the JAX
    package's training attention instead: :func:`gqa_attend` up to
    ``BLOCKWISE_THRESHOLD`` tokens, ``blockwise_gqa_attend`` above."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg, positions)
    if not train:
        out = _flash(q, k, v, causal=causal, window=window, impl=impl)
    elif S > BLOCKWISE_THRESHOLD:
        out = _local(lambda q, k, v: blockwise_gqa_attend(
            q, k, v, causal=causal, window=window), q, k, v)
    else:
        out = _local(lambda q, k, v: gqa_attend(q, k, v, attention_mask(
            S, S, causal=causal, window=window, device=q.device)), q, k, v)
    y = out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ params["wo"]
    if return_kv:
        return y, {"k": k, "v": v}
    return y


def _local(fn, q, *kv, shared: tuple = ()):
    """``fn(q, *kv)``; on DTensors each rank's over its own batch rows and
    heads (``distributed.spmd.local_heads``), the attention of a GSPMD
    program sharded by heads."""
    if not is_dtensor(q):
        return fn(q, *kv)
    return local_heads(fn, q, *kv, shared=shared)


def _flash(q, k, v, **kw):
    """The flash kernel wrapper, through :func:`_local`."""
    return _local(lambda a, b, c: flash_attention(
        a.contiguous(), b.contiguous(), c.contiguous(), **kw), q, k, v)


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
        raise NotImplementedError(_RING_DECODE)
    posv = _pos_vec(cache_pos, x.shape[0], x.device)
    return _decode_into(params, x, cache, posv, posv, posv + 1, cfg, impl)


def gqa_decode_ring(params, x, cache: dict, cache_pos, cfg: ModelConfig,
                    *, window: int, impl: str | None = None):
    """Single-token decode of a sliding-window layer over its ring cache
    (the JAX package's ``gqa_decode_ring``).  x (B,1,d); cache k/v (B,W′,
    K,hd), W′ = min(window, s_max); cache_pos: int or (B,) absolute
    positions, which may exceed W′.

    Writes the new token's K/V **in place** at slot ``pos % W′``, then
    attends with the paged kernel over the ring viewed as a page pool with
    ``seq_lens = min(pos + 1, W′)``: slot s holds position ``pos - ((pos -
    s) mod W′)``, valid when it is >= 0 (the JAX mask), which is every slot
    once the ring is full and the slots ``0 .. pos`` before.  Keys are
    stored after RoPE, so the slots' order does not matter.  ``window``
    is the layer's (the ring's length already holds it).  Returns (y
    (B,1,d), cache)."""
    W = cache["k"].shape[1]
    if not 0 < W <= window:
        raise ValueError(f"a ring of {W} slots for a window of {window}: "
                         f"it holds min(window, s_max) slots")
    posv = _pos_vec(cache_pos, x.shape[0], x.device)
    return _decode_into(params, x, cache, posv, posv % W,
                        torch.clamp(posv + 1, max=W), cfg, impl)


def _decode_into(params, x, cache: dict, posv, slots, lens,
                 cfg: ModelConfig, impl: str | None):
    """The token at absolute positions ``posv`` (B,): its K/V written in
    place at cache rows ``slots``, then paged attention over the first
    ``lens`` rows of each row's cache."""
    B = x.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = head_reshape(x @ params["wq"], B, 1, H, hd, heads=H)
    k_new = head_reshape(x @ params["wk"], B, 1, K, hd, heads=K)
    v_new = head_reshape(x @ params["wv"], B, 1, K, hd, heads=K)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k_new = rms_norm(k_new, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, posv[:, None], cfg.rope_theta)
    k_new = apply_rope(k_new, posv[:, None], cfg.rope_theta)
    kc, vc = cache["k"], cache["v"]
    if is_dtensor(kc):
        out = sharded_decode(q[:, 0], [k_new[:, 0], v_new[:, 0]], [kc, vc],
                             slots, lens, scale=None, impl=impl)
        return out.to(x.dtype).reshape(B, 1, H * hd) @ params["wo"], cache
    rows = torch.arange(B, device=x.device)
    kc[rows, slots] = k_new[:, 0].to(kc.dtype)
    vc[rows, slots] = v_new[:, 0].to(vc.dtype)
    n_slots, length = kc.shape[:2]
    page = math.gcd(length, DECODE_PAGE)
    pages = length // page
    kp = kc.view(n_slots * pages, page, K, hd)
    vp = vc.view(n_slots * pages, page, K, hd)
    table = _slot_block_table(n_slots, pages, kc.device)[:B]
    out = paged_attention(q[:, 0].to(kc.dtype), kp, vp, table,
                          lens.to(torch.int32), impl=impl)
    y = out.to(x.dtype).reshape(B, 1, H * hd) @ params["wo"]
    return y, cache


def sharded_decode(q, rows: list, caches: list, slots, lens, *, scale,
                   impl: str | None = None, hd_v: int | None = None):
    """Decode attention over DTensor caches whose sequence (dim 1) is
    sharded, the JAX package's flash-decode sharding
    (``distributed/sharding.py::cache_spec``): no rank gathers a cache.

    q (B,H,dk); ``rows`` the new token's rows (B, *row), one a cache in
    ``caches`` ((B,S,K,dk) keys then (B,S,K,dv) values; or MLA's one
    (B,S,1,r+rd) cache, whose first ``hd_v`` columns are the values);
    ``slots`` (B,) where each row's token goes, ``lens`` (B,) the positions
    each row attends to.  Through ``local_map``, each rank writes the new
    rows that fall in its own positions, in place, then runs the paged
    kernel (``paged_attention_partials``) over its local positions, its
    slot cache viewed as pages, and combines its partitions' states into
    one (max, sum, unnormalised output) (``combine_partials_ref``); the
    ranks of the sequence's mesh dim all-gather those, B·H·(dv + 2) floats
    a rank, and merge them (``merge_partials_ref``).  The batch keeps the
    caches' batch sharding.  Returns (B,H,dv) in the caches' dtype,
    replicated over the sequence's mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from ..distributed.spmd import all_gather
    mesh = caches[0].device_mesh
    cp = list(caches[0].placements)
    if any(isinstance(p, Shard) and p.dim > 1 for p in cp):
        # cache_spec's fallback when the sequence does not divide
        raise NotImplementedError(f"decode over a cache sharded along its "
                                  f"features ({cp}): give it a sequence "
                                  f"that divides over the mesh")
    bp = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in cp]
    seq_dim = next((i for i, p in enumerate(cp)
                    if isinstance(p, Shard) and p.dim == 1), None)
    n_seq = mesh.size(seq_dim) if seq_dim is not None else 1
    seq_rank = mesh.get_local_rank(seq_dim) if seq_dim is not None else 0

    def local(q_l, slots_l, lens_l, *rest):
        rows_l, caches_l = rest[:len(rows)], rest[len(rows):]
        c0 = caches_l[0]
        B_l, S_l = c0.shape[:2]
        idx = torch.arange(B_l, device=c0.device)
        loc = slots_l.long() - seq_rank * S_l
        mine = (loc >= 0) & (loc < S_l)
        at = loc.clamp(0, S_l - 1)
        for c, r in zip(caches_l, rows_l):
            keep = mine.view(-1, *([1] * (c.dim() - 2)))
            c[idx, at] = torch.where(keep, r.to(c.dtype), c[idx, at])
        lens_loc = (lens_l.long() - seq_rank * S_l).clamp(0, S_l)
        page = math.gcd(S_l, DECODE_PAGE)
        pages = S_l // page
        K, dk = c0.shape[2], c0.shape[3]
        kp = c0.view(B_l * pages, page, K, dk)
        vc = caches_l[-1]
        vp = (kp[..., :hd_v] if len(caches_l) == 1 and hd_v is not None
              else vc.view(B_l * pages, page, K, vc.shape[3]))
        table = _slot_block_table(B_l, pages, c0.device)
        m, l, o = combine_partials_ref(*paged_attention_partials(
            q_l.to(c0.dtype).contiguous(), kp, vp, table,
            lens_loc.to(torch.int32), scale=scale, impl=impl))
        if n_seq > 1:      # every rank's state, in sequence order
            st = torch.cat([o, m[..., None], l[..., None]], dim=-1)
            g = all_gather(st.contiguous(), (mesh, seq_dim))
            g = g.view(n_seq, *st.shape).movedim(0, 2).flatten(2, 3)
            m, l, o = g[..., -2], g[..., -1], g[..., :-2]
        return merge_partials_ref(m, l, o, dtype=c0.dtype)

    args = [replicated(t, mesh) for t in (q, slots, lens, *rows)]
    return local_map(local, out_placements=bp,
                     in_placements=(bp,) * len(args) + (cp,) * len(caches),
                     device_mesh=mesh, redistribute_inputs=True)(*args, *caches)


def ring_cache_from_prefill(kv: dict, window: int, true_lens=None) -> dict:
    """A prefill's ``{"k", "v"}`` (B,S,K,hd) as ring caches of W = min(window,
    S) slots: row b keeps its positions ``max(0, L_b - W) .. L_b - 1``, each
    at slot ``pos % W``, and zeros elsewhere, where L_b is the row's true
    length (``true_lens``, default S).  The JAX package's
    ``ring_cache_from_prefill`` keeps the last W positions of the padded
    length S instead: the same ring where L_b = S or S <= W, but for a
    shorter row in a bucket longer than the window it keeps pad positions
    and loses real ones still inside the window.  When S <= W the slots are
    the positions themselves, so the ring widens to a decode ring of any
    W′ >= S by zeros past S (``ServingEngine._write_slot``)."""
    k = kv["k"]
    B, S = k.shape[:2]
    W = min(window, S) if window else S
    lens = (torch.full((B,), S, dtype=torch.long, device=k.device)
            if true_lens is None else
            torch.as_tensor(true_lens, device=k.device).long())
    last = (lens - 1)[:, None]                                  # (B, 1)
    slot = torch.arange(W, device=k.device)[None]               # (1, W)
    pos = last - torch.remainder(last - slot, W)                # (B, W)
    valid = (pos >= 0)[:, :, None, None]
    idx = pos.clamp(min=0)[:, :, None, None].expand(B, W, *k.shape[2:])
    out = {}
    for name in ("k", "v"):
        t = kv[name]
        out[name] = torch.where(valid, torch.gather(t, 1, idx),
                                torch.zeros((), dtype=t.dtype,
                                            device=t.device))
    return out


def gqa_chunk_decode(params, x, cache: dict, pos0, cfg: ModelConfig,
                     *, window: int = 0, impl: str | None = None):
    """One contiguous C-token span against a resident cache: x (B,C,d) at
    absolute positions ``pos0 .. pos0+C-1`` (one scalar ``pos0`` for every
    row); cache k/v (B,S_max,K,hd).

    Writes the span's K/V into ``cache`` **in place** at ``pos0``, then
    attends with the flash kernel over the whole cache tensor
    (``q_offset=pos0``, ``kv_len=pos0+C``: each query sees every resident
    key up to its own position, the JAX mask ``k_pos <= pos``).  ``pos0=0``
    is a plain prefill, C=1 a decode step.  A windowed layer raises: the
    JAX engine gates chunked mode off for ring caches
    (``transformer.supports_chunked_decode``).  Returns (y (B,C,d),
    cache)."""
    if window and window > 0:
        raise NotImplementedError(_RING_CHUNK)
    B, C, _ = x.shape
    pos0 = int(pos0)
    kc, vc = cache["k"], cache["v"]
    if pos0 < 0 or pos0 + C > kc.shape[1]:
        raise ValueError(f"chunk of {C} at position {pos0} does not fit a "
                         f"cache of {kc.shape[1]} positions")
    positions = torch.arange(pos0, pos0 + C, dtype=torch.int32,
                             device=x.device)[None].expand(B, C)
    q, k_new, v_new = _qkv(params, x, cfg, positions)
    kc[:, pos0:pos0 + C] = k_new.to(kc.dtype)
    vc[:, pos0:pos0 + C] = v_new.to(vc.dtype)
    out = flash_attention(q.to(kc.dtype).contiguous(), kc, vc, causal=True,
                          q_offset=pos0, kv_len=pos0 + C, impl=impl)
    y = out.to(x.dtype).reshape(B, C, cfg.n_heads * cfg.head_dim) @ params["wo"]
    return y, cache


def _mla_scale(cfg: ModelConfig) -> float:
    return (cfg.head_dim + cfg.rope_head_dim) ** -0.5


def mla_forward(params, x, cfg: ModelConfig, *, positions,
                causal: bool = True, window: int = 0,
                return_kv: bool = False, impl: str | None = None,
                train: bool = False):
    """Full-sequence MLA.  Prefill folds into MHA form: queries and keys
    ``[nope ‖ rope]`` of hd + rd (the rope key shared by every head),
    values of vd, scale ``(hd + rd)^-0.5``, through the flash kernel.  The
    training forward (``train``) runs the JAX package's training MLA
    instead, in torch ops: up to ``BLOCKWISE_THRESHOLD`` tokens the
    two-term scores (nope against the decompressed keys plus the rope
    query against the shared rope key), masked and softmaxed in f32; above
    it the same MHA fold through ``blockwise_gqa_attend``.  x (B,S,d) →
    (B,S,d), plus the layer's ``{"ckv"}`` (B,S,1,r+rd) when
    ``return_kv``."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    r, rd, vd = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.v_head_dim
    q = head_reshape(x @ params["wq"], B, S, H, hd + rd, heads=H)
    c = rms_norm(x @ params["w_dkv"], params["kv_norm"], cfg.norm_eps)
    q_rope = apply_rope(q[..., hd:], positions, cfg.rope_theta)
    k_rope = apply_rope((x @ params["w_krope"]).reshape(B, S, 1, rd),
                        positions, cfg.rope_theta)
    k_nope = head_reshape(c @ params["w_uk"], B, S, H, hd, heads=H)
    v = head_reshape(c @ params["w_uv"], B, S, H, vd, heads=H)
    if train and S <= BLOCKWISE_THRESHOLD:
        def attend(q_nope, k_nope, v, q_rope, k_rope):
            scores = (torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
                      + torch.einsum("bshd,btzd->bhst", q_rope, k_rope)
                      ) * _mla_scale(cfg)
            mask = attention_mask(S, S, causal=causal, window=window,
                                  device=q_nope.device)
            scores = torch.where(mask, scores.float(),
                                 torch.finfo(torch.float32).min)
            probs = torch.softmax(scores, dim=-1).to(v.dtype)
            return torch.einsum("bhst,bthd->bshd", probs, v)
        out = _local(attend, q[..., :hd], k_nope, v, q_rope, k_rope,
                     shared=(4,))
    else:
        q_full = torch.cat([q[..., :hd], q_rope], dim=-1)
        k_full = torch.cat([k_nope, k_rope.expand(B, S, H, rd)], dim=-1)
        if train:
            out = _local(lambda q, k, v: blockwise_gqa_attend(
                q, k, v, causal=causal, window=window,
                scale=_mla_scale(cfg)), q_full, k_full, v)
        else:
            out = _flash(q_full, k_full, v, causal=causal, window=window,
                         scale=_mla_scale(cfg), impl=impl)
    y = head_reshape(out, B, S, H * vd, heads=H) @ params["wo"]
    if return_kv:
        return y, {MLA_CACHE: torch.cat([c, k_rope[:, :, 0]], dim=-1)[:, :, None]}
    return y


def mla_decode(params, x, cache: dict, cache_pos, cfg: ModelConfig,
               *, window: int = 0, impl: str | None = None):
    """Absorbed single-token MLA decode.  x (B,1,d); cache ``{"ckv"}``
    (B,S_max,1,r+rd); cache_pos: int or (B,) — tokens already in each
    row's cache (< S_max).

    Writes the new token's latent and rope key into ``cache`` **in place**,
    then attends with the paged kernel over the cache viewed as a page pool
    of one KV head: the query ``[q_nope·W_uk ‖ q_rope]`` (B,H,r+rd) scores
    every cached row, the values are the rows' first r columns (a strided
    view, no copy), and the context (B,H,r) goes through W_uv and the
    output projection.  Returns (y (B,1,d), cache)."""
    if window and window > 0:
        raise NotImplementedError(_RING_DECODE)
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    r, rd, vd = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.v_head_dim
    posv = _pos_vec(cache_pos, B, x.device)
    q = head_reshape(x @ params["wq"], B, 1, H, hd + rd, heads=H)
    q_rope = apply_rope(q[..., hd:], posv[:, None], cfg.rope_theta)[:, 0]
    c_new = rms_norm(x @ params["w_dkv"], params["kv_norm"], cfg.norm_eps)
    k_rope_new = apply_rope((x @ params["w_krope"]).reshape(B, 1, 1, rd),
                            posv[:, None], cfg.rope_theta)
    ckv = cache[MLA_CACHE]
    row = torch.cat([c_new[:, 0], k_rope_new[:, 0, 0]], dim=-1)
    q_eff = torch.einsum("bhd,rhd->bhr", q[:, 0, :, :hd],
                         params["w_uk"].reshape(r, H, hd))
    q_cat = torch.cat([q_eff, q_rope], dim=-1).to(ckv.dtype)
    if is_dtensor(ckv):
        ctx = sharded_decode(q_cat, [row[:, None]], [ckv], posv, posv + 1,
                             scale=_mla_scale(cfg), impl=impl, hd_v=r)
        out = torch.einsum("bhr,rhd->bhd", ctx.to(x.dtype),
                           params["w_uv"].reshape(r, H, vd))
        return head_reshape(out, B, 1, H * vd, heads=H) @ params["wo"], cache
    rows = torch.arange(B, device=x.device)
    ckv[rows, posv, 0] = row.to(ckv.dtype)
    n_slots, s_max = ckv.shape[:2]
    page = math.gcd(s_max, DECODE_PAGE)
    pages = s_max // page
    kp = ckv.view(n_slots * pages, page, 1, r + rd)
    table = _slot_block_table(n_slots, pages, ckv.device)[:B]
    seq_lens = (posv + 1).to(torch.int32)
    ctx = paged_attention(q_cat, kp, kp[..., :r], table, seq_lens,
                          scale=_mla_scale(cfg), impl=impl)
    out = torch.einsum("bhr,rhd->bhd", ctx.to(x.dtype),
                       params["w_uv"].reshape(r, H, vd))
    y = out.reshape(B, 1, H * vd) @ params["wo"]
    return y, cache


def mla_chunk_decode(params, x, cache: dict, pos0, cfg: ModelConfig,
                     *, window: int = 0, impl: str | None = None):
    """One contiguous C-token span of MLA against a resident latent cache
    (the JAX package's ``mla_chunk_decode``; contract of
    :func:`gqa_chunk_decode`): x (B,C,d) at positions ``pos0 .. pos0+C-1``;
    cache ``{"ckv"}`` (B,S_max,1,r+rd).

    Writes the span's latent ‖ rope-key rows into ``cache`` **in place** at
    ``pos0``, then attends in MHA form, as :func:`mla_forward` does: the
    first ``pos0 + C`` latent rows are decompressed through W_uk and W_uv
    into keys ``[nope ‖ rope]`` of hd + rd and values of vd, and the flash
    kernel runs the chunk's queries at ``q_offset=pos0`` over them.  JAX
    scores the absorbed query against the latent rows instead; the two are
    the same sums in another order.  Decompressing costs 2·T·r·H·(hd + vd)
    FLOPs for T = pos0 + C rows, about as long on the card as the flash
    call (``chip_smoke.py::phase_mla_chunk_cost``).  Returns (y (B,C,d),
    cache)."""
    if window and window > 0:
        raise NotImplementedError(_RING_CHUNK)
    B, C, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    r, rd, vd = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.v_head_dim
    pos0 = int(pos0)
    ckv = cache[MLA_CACHE]
    if pos0 < 0 or pos0 + C > ckv.shape[1]:
        raise ValueError(f"chunk of {C} at position {pos0} does not fit a "
                         f"cache of {ckv.shape[1]} positions")
    positions = torch.arange(pos0, pos0 + C, dtype=torch.int32,
                             device=x.device)[None].expand(B, C)
    q = (x @ params["wq"]).reshape(B, C, H, hd + rd)
    q_rope = apply_rope(q[..., hd:], positions, cfg.rope_theta)
    c_new = rms_norm(x @ params["w_dkv"], params["kv_norm"], cfg.norm_eps)
    k_rope_new = apply_rope((x @ params["w_krope"]).reshape(B, C, 1, rd),
                            positions, cfg.rope_theta)
    ckv[:, pos0:pos0 + C, 0] = torch.cat([c_new, k_rope_new[:, :, 0]],
                                         dim=-1).to(ckv.dtype)
    T = pos0 + C
    rows = ckv[:, :T, 0].to(x.dtype)                   # (B, T, r + rd)
    latent = rows[..., :r]
    k_nope = (latent @ params["w_uk"]).reshape(B, T, H, hd)
    v = (latent @ params["w_uv"]).reshape(B, T, H, vd)
    k_full = torch.cat([k_nope, rows[:, :, None, r:].expand(B, T, H, rd)],
                       dim=-1)
    q_full = torch.cat([q[..., :hd], q_rope], dim=-1)
    out = flash_attention(*(t.to(ckv.dtype).contiguous()
                            for t in (q_full, k_full, v)),
                          causal=True, q_offset=pos0, kv_len=T,
                          scale=_mla_scale(cfg), impl=impl)
    y = out.to(x.dtype).reshape(B, C, H * vd) @ params["wo"]
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
                 return_kv: bool = False, impl: str | None = None,
                 train: bool = False):
    """Prefill attention of a layer of kind ``kind``, or with ``train`` its
    training attention (GQA or MLA), which reaches no kernel wrapper."""
    if cfg.use_mla:
        return mla_forward(params, x, cfg, positions=positions,
                           causal=cfg.causal, window=window_for(cfg, kind),
                           return_kv=return_kv, impl=impl, train=train)
    return gqa_forward(params, x, cfg, window=window_for(cfg, kind),
                       positions=positions, causal=cfg.causal,
                       return_kv=return_kv, impl=impl, train=train)


def attn_decode(params, x, cache, cache_pos, cfg: ModelConfig, kind: str,
                impl: str | None = None):
    """Single-token decode attention of a layer of kind ``kind``."""
    if cfg.use_mla:
        return mla_decode(params, x, cache, cache_pos, cfg,
                          window=window_for(cfg, kind), impl=impl)
    return gqa_decode(params, x, cache, cache_pos, cfg,
                      window=window_for(cfg, kind), impl=impl)


def attn_chunk_decode(params, x, cache, pos0, cfg: ModelConfig, kind: str,
                      impl: str | None = None):
    """Chunked-prefill attention of a layer of kind ``kind``."""
    if cfg.use_mla:
        return mla_chunk_decode(params, x, cache, pos0, cfg,
                                window=window_for(cfg, kind), impl=impl)
    return gqa_chunk_decode(params, x, cache, pos0, cfg,
                            window=window_for(cfg, kind), impl=impl)
