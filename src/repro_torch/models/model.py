"""Model facade for serving: parameters, prefill, decode step, decode caches.

Ported from the JAX package's ``models/model.py`` for the dense attention
families and the SSM family.  ``chunk_step``, ``train_loss`` and the MoE
and RG-LRU families come with later steps of the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..configs.base import ModelConfig
from .common import DtypePolicy, dense_init, embed_init, resolve_device, rms_norm
from .transformer import (check_supported, init_stack, init_stack_cache,
                          stack_decode, stack_forward)


class LMParams(nn.Module):
    """All weights of one language model: ``blocks`` (an ``nn.ModuleList``
    of per-layer blocks), ``final_norm``, ``embed`` and, when embeddings are
    not tied, ``head``.  Inference only: the parameters do not require
    grad."""

    def __init__(self, blocks: nn.ModuleList, final_norm: torch.Tensor,
                 embed: torch.Tensor, head: torch.Tensor | None = None):
        super().__init__()
        self.blocks = blocks
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.head = (nn.Parameter(head, requires_grad=False)
                     if head is not None else None)


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device="cuda", dtype=torch.float32) -> LMParams:
    """Random weights for ``cfg`` drawn from ``generator``, which must live
    on ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    blocks = init_stack(generator, cfg, dtype, dev)
    final_norm = torch.zeros((cfg.d_model,), dtype=dtype, device=dev)
    embed = embed_init(generator, cfg.vocab_size, cfg.d_model, dtype, dev)
    head = (None if cfg.tie_embeddings else
            dense_init(generator, cfg.d_model, cfg.vocab_size, dtype, dev))
    return LMParams(blocks, final_norm, embed, head)


def _unembed(params: LMParams, cfg: ModelConfig) -> torch.Tensor:
    if params.head is not None:
        return params.head
    return params.embed.T                          # tied


def _embed_inputs(params: LMParams, batch: dict, cfg: ModelConfig,
                  compute_dtype) -> torch.Tensor:
    x = params.embed[batch["tokens"].long()]
    if cfg.tie_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32)
    return x.to(compute_dtype)


def _softcap(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.logit_softcap:
        return cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


@torch.no_grad()
def prefill(params: LMParams, batch: dict, cfg: ModelConfig, *,
            policy: DtypePolicy = DtypePolicy.serve(),
            true_lens=None, impl: str | None = None):
    """Full-prompt forward.  batch {"tokens": (B,S) int}; ``true_lens``
    (B,) the real lengths of right-padded rows, or None for all S.  Returns
    (logits at each row's last real position (B,1,V) f32, per-layer caches:
    ``{"k", "v"}`` (B,S,K,hd) for attention, ``{"ssm", "conv"}`` after the
    last real position for SSM layers)."""
    x = _embed_inputs(params, batch, cfg, policy.compute)
    B, S = x.shape[:2]
    h, caches = stack_forward(params.blocks, x, cfg, _positions(B, S, x.device),
                              want_cache=True, true_lens=true_lens, impl=impl)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
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
                impl: str | None = None):
    """One token for every sequence.  tokens (B,1) int; cache_pos an int or
    (B,) per-row positions (tokens already in each cache, < S_max; SSM
    layers do not read them).  The caches are updated **in place**.
    Returns (logits (B,1,V) f32, caches)."""
    s_max = next((c["k"].shape[1] for c in caches if "k" in c), None)
    if s_max is not None and isinstance(cache_pos, (int, np.integer,
                                                    np.ndarray)):
        host = np.asarray(cache_pos)
        if np.any(host >= s_max) or np.any(host < 0):
            raise ValueError(f"cache positions must lie in [0, {s_max})")
    # one host-to-device copy per step, not one per layer
    cache_pos = torch.as_tensor(cache_pos, device=tokens.device).long()
    x = params.embed[tokens.long()].to(policy.compute)
    if cfg.tie_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=policy.compute)
    h, caches = stack_decode(params.blocks, x, caches, cache_pos, cfg,
                             impl=impl)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    w_head = _unembed(params, cfg)
    logits = (h.to(w_head.dtype) @ w_head).float()
    return _softcap(logits, cfg), caches


def init_decode_caches(cfg: ModelConfig, batch: int, s_max: int, *,
                       dtype=torch.bfloat16, device="cuda") -> list[dict]:
    """Zero per-layer decode caches (``transformer.init_block_cache``)."""
    return init_stack_cache(cfg, batch, s_max, dtype, resolve_device(device))
