"""Model facade: parameters, training loss, prefill, decode step, decode
caches.

Ported from the JAX package's ``models/model.py`` for every family it
serves: the dense attention families (sliding-window and local/global
layers included), MLA and MoE (deepseek-v2-lite, phi3.5-moe), the SSM
family, the RG-LRU hybrid family (recurrentgemma), models fed embeddings
(internvl2: ``{"embeddings": (B, S, d)}`` in prefill, tokens in decode)
and encoder-only models (hubert: no embedding table, bidirectional
attention, per-position logits and no cache from :func:`prefill`).
``moe_impl`` picks the MoE path (``dropping``, the JAX engine's default,
or ``dense``).  :func:`train_loss` trains every family the JAX package
trains: the attention families (full, local, global and sliding-window
layers; GQA or MLA; causal or bidirectional; dense, GeLU or MoE MLPs; token
or embedding inputs) through the training attention of
``models/attention.py``, the SSM family through ``ssm.ssd_chunked`` and the
RG-LRU hybrid family through ``rglru_forward``'s scan, all in torch ops
that autograd differentiates; no kernel wrapper is reached.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..configs.base import ModelConfig
from ..distributed.spmd import embed_lookup, label_logits
from .common import DtypePolicy, dense_init, embed_init, resolve_device, rms_norm
from .transformer import (SEQ_CACHE_ENTRIES, check_supported, init_stack,
                          init_stack_cache, layer_kinds, stack_chunk,
                          stack_decode, stack_forward, stack_train_forward,
                          uses_ring)

AUX_LOSS_WEIGHT = 0.01


class LMParams(nn.Module):
    """All weights of one language model: ``blocks`` (an ``nn.ModuleList``
    of per-layer blocks), ``final_norm``, ``embed`` (None for an
    encoder-only model fed embeddings, which has no table) and, when
    embeddings are not tied or there is no table, ``head``.  Built frozen
    for serving; ``requires_grad_(True)`` makes every weight trainable
    (``training.init_train_state`` does)."""

    def __init__(self, blocks: nn.ModuleList, final_norm: torch.Tensor,
                 embed: torch.Tensor | None,
                 head: torch.Tensor | None = None):
        super().__init__()
        if embed is None and head is None:
            raise ValueError("a model without an embedding table needs a "
                             "head")
        self.blocks = blocks
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.embed = (nn.Parameter(embed, requires_grad=False)
                      if embed is not None else None)
        self.head = (nn.Parameter(head, requires_grad=False)
                     if head is not None else None)


def needs_embed(cfg: ModelConfig) -> bool:
    """Whether ``cfg`` has an embedding table: every model fed tokens, and
    every decoder (its decode steps take tokens), as in JAX; an encoder fed
    embeddings (hubert) has none."""
    return cfg.input_mode == "tokens" or not cfg.is_encoder_only


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device="cuda", dtype=torch.float32) -> LMParams:
    """Random weights for ``cfg`` drawn from ``generator``, which must live
    on ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    blocks = init_stack(generator, cfg, dtype, dev)
    final_norm = torch.zeros((cfg.d_model,), dtype=dtype, device=dev)
    has_embed = needs_embed(cfg)
    embed = (embed_init(generator, cfg.vocab_size, cfg.d_model, dtype, dev)
             if has_embed else None)
    head = (None if cfg.tie_embeddings and has_embed else
            dense_init(generator, cfg.d_model, cfg.vocab_size, dtype, dev))
    return LMParams(blocks, final_norm, embed, head)


def _unembed(params: LMParams, cfg: ModelConfig) -> torch.Tensor:
    if params.head is not None:
        return params.head
    return params.embed.T                          # tied


def _embed_inputs(params: LMParams, batch: dict, cfg: ModelConfig,
                  compute_dtype) -> torch.Tensor:
    if cfg.input_mode == "embeddings":   # cast only: no √d scaling, as JAX
        return batch["embeddings"].to(compute_dtype)
    x = embed_lookup(batch["tokens"].long(), params.embed)
    if cfg.tie_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32)
    return x.to(compute_dtype)


def _check_decodes(params: LMParams, cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a model that cannot take tokens: an encoder
    fed embeddings has no table to embed them (and no decode cache)."""
    if params.embed is None:
        raise ValueError(f"{cfg.name} has no embedding table (an encoder-"
                         f"only model fed embeddings): it runs prefill "
                         f"only, not decode or chunk steps")


def _softcap(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.logit_softcap:
        return cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def chunked_cross_entropy(hidden, w_head, labels, *, chunk: int = 512,
                          softcap: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy over all positions, in sequence chunks of
    ``chunk`` (halved until it divides S) so that the (B, S, V) logits never
    exist at once.  hidden (B,S,d), w_head (d,V), labels (B,S).  Logits in
    f32 (after the optional softcap); the label's logit by a gather, the
    same sum as JAX's one-hot einsum."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, S, chunk):
        logits = (hidden[:, c:c + chunk].to(w_head.dtype) @ w_head).float()
        if softcap:
            logits = softcap * torch.tanh(logits / softcap)
        lse = torch.logsumexp(logits, dim=-1)
        ll = label_logits(logits, labels[:, c:c + chunk].long())
        total = total + (lse - ll).sum()
    return total / (B * S)


def train_loss(params: LMParams, batch: dict, cfg: ModelConfig, *,
               policy: DtypePolicy = DtypePolicy.train(),
               remat: bool = True, moe_impl: str = "dropping") -> torch.Tensor:
    """Mean next-token cross-entropy plus ``AUX_LOSS_WEIGHT`` times the MoE
    load-balancing loss, differentiable in every weight.  batch
    {"tokens" or "embeddings", "labels": (B,S)}.

    The casts are JAX's, inside the autograd graph: every f32 block weight
    of two or more dims (the MoE router too) to ``policy.compute``, norm
    scales kept f32; embedding rows taken from the f32 table (scaled by √d
    when tied) then cast; the head cast.  ``remat`` checkpoints each period
    of the stack, and its head and tail blocks
    (``transformer.stack_train_forward``).  Every layer kind
    trains: attention (GQA or MLA), SSM and RG-LRU."""
    x = _embed_inputs(params, batch, cfg, policy.compute)
    B, S = x.shape[:2]

    def cast(t):
        return (t.to(policy.compute)
                if t.dtype == torch.float32 and t.dim() >= 2 else t)

    h, aux = stack_train_forward([bp.cast(cast) for bp in params.blocks], x,
                                 cfg, _positions(B, S, x.device),
                                 moe_impl=moe_impl, remat=remat)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    w_head = _unembed(params, cfg).to(policy.compute)
    loss = chunked_cross_entropy(h, w_head, batch["labels"],
                                 softcap=cfg.logit_softcap)
    return loss + AUX_LOSS_WEIGHT * aux


@torch.no_grad()
def prefill(params: LMParams, batch: dict, cfg: ModelConfig, *,
            policy: DtypePolicy = DtypePolicy.serve(),
            true_lens=None, impl: str | None = None,
            moe_impl: str = "dropping"):
    """Full-prompt forward.  batch {"tokens": (B,S) int}, or for a model
    fed embeddings {"embeddings": (B,S,d)} (cast to the compute dtype);
    ``true_lens`` (B,) the real lengths of right-padded rows, or None for
    all S.  Returns (logits at each row's last real position (B,1,V) f32,
    per-layer caches: ``{"k", "v"}`` (B,S,K,hd) for GQA — for a
    sliding-window layer its ring of min(window, S) slots, built from each
    row's true length — ``{"ckv"}`` (B,S,1,r+rd) for MLA, ``{"ssm",
    "conv"}`` or ``{"h", "conv"}`` after the last real position for SSM or
    RG-LRU layers).  An encoder-only model returns (per-position logits
    (B,S,V) f32 without softcap, None): its attention is bidirectional
    over all S positions, with no key-padding mask, as in JAX."""
    x = _embed_inputs(params, batch, cfg, policy.compute)
    B, S = x.shape[:2]
    encoder = cfg.is_encoder_only
    h, caches = stack_forward(params.blocks, x, cfg, _positions(B, S, x.device),
                              want_cache=not encoder, true_lens=true_lens,
                              impl=impl, moe_impl=moe_impl)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    if encoder:
        w_head = _unembed(params, cfg)
        return (h.to(w_head.dtype) @ w_head).float(), None
    if true_lens is None:
        h_last = h[:, -1:]
    else:
        rows = torch.arange(B, device=x.device)
        h_last = h[rows, true_lens.to(x.device).long() - 1][:, None]
    w_head = _unembed(params, cfg)
    logits = (h_last.to(w_head.dtype) @ w_head).float()
    return _softcap(logits, cfg), caches


@torch.no_grad()
def decode_step(params: LMParams, tokens, caches: list, cache_pos,
                cfg: ModelConfig, *,
                policy: DtypePolicy = DtypePolicy.serve(),
                impl: str | None = None, moe_impl: str = "dropping"):
    """One token for every sequence.  tokens (B,1) int; cache_pos an int or
    (B,) per-row positions (tokens already in each cache, < S_max of the
    full caches; a ring cache takes any position, and SSM and RG-LRU
    layers do not read them).  The caches are updated **in place**.  Returns (logits
    (B,1,V) f32, caches)."""
    _check_decodes(params, cfg)
    s_max = next((t.shape[1] for c, kind in zip(caches, layer_kinds(cfg))
                  if not uses_ring(cfg, kind)
                  for name, t in c.items() if name in SEQ_CACHE_ENTRIES),
                 None)
    if s_max is not None and isinstance(cache_pos, (int, np.integer,
                                                    np.ndarray)):
        host = np.asarray(cache_pos)
        if np.any(host >= s_max) or np.any(host < 0):
            raise ValueError(f"cache positions must lie in [0, {s_max})")
    # one host-to-device copy per step, not one per layer
    cache_pos = torch.as_tensor(cache_pos, device=tokens.device).long()
    x = embed_lookup(tokens.long(), params.embed).to(policy.compute)
    if cfg.tie_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=policy.compute)
    h, caches = stack_decode(params.blocks, x, caches, cache_pos, cfg,
                             impl=impl, moe_impl=moe_impl)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    w_head = _unembed(params, cfg)
    logits = (h.to(w_head.dtype) @ w_head).float()
    return _softcap(logits, cfg), caches


@torch.no_grad()
def chunk_step(params: LMParams, tokens, caches: list, pos0,
               cfg: ModelConfig, *, policy: DtypePolicy = DtypePolicy.serve(),
               impl: str | None = None, moe_impl: str = "dropping"):
    """Prefill one C-token chunk against existing decode caches.

    tokens (B,C) int; ``pos0`` an int — tokens already resident in every
    row's cache (the chunk occupies absolute positions pos0..pos0+C-1).
    The caches are updated **in place** (pass a slot's ``[s:s+1]`` views to
    prefill one slot).  Returns (logits at the chunk's last position (B,1,V)
    f32, caches).  With pos0=0 and C=prompt_len this is a whole prefill;
    with C=1 a decode step.  Requires
    ``transformer.supports_chunked_decode(cfg)``."""
    _check_decodes(params, cfg)
    x = embed_lookup(tokens.long(), params.embed).to(policy.compute)
    if cfg.tie_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=policy.compute)
    h, caches = stack_chunk(params.blocks, x, caches, pos0, cfg, impl=impl,
                            moe_impl=moe_impl)
    h = rms_norm(h[:, -1:], params.final_norm, cfg.norm_eps)
    w_head = _unembed(params, cfg)
    logits = (h.to(w_head.dtype) @ w_head).float()
    return _softcap(logits, cfg), caches


def init_decode_caches(cfg: ModelConfig, batch: int, s_max: int, *,
                       dtype=torch.bfloat16, device="cuda") -> list[dict]:
    """Zero per-layer decode caches (``transformer.init_block_cache``):
    s_max rows for a full layer, min(window, s_max) for a ring."""
    return init_stack_cache(cfg, batch, s_max, dtype, resolve_device(device))
