"""Layer stack assembly for the attention and SSM layer kinds.

The JAX package runs ``head`` blocks, a ``jax.lax.scan`` over periods of
``cfg.pattern`` and ``tail`` blocks, with stacked period weights.  Here the
layers are an ``nn.ModuleList`` of per-layer :class:`Block`\\ s in layer
order and the scan is a Python loop; ``stack_layout`` and ``layer_kinds``
keep the JAX meaning.  The decode cache is a per-layer list of dicts,
updated in place by :func:`stack_decode`: ``{"k", "v"}`` for an attention
layer, ``{"ssm", "conv"}`` for an SSM layer.

Attention kinds without a ring cache and the SSM kind are ported: MoE,
RG-LRU, MLA and sliding-window layers raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from .attention import attn_decode, attn_forward, init_attention
from .common import rms_norm
from .mlp import init_mlp, mlp_forward
from .ssm import init_ssm, init_ssm_cache, ssm_decode, ssm_forward

ATTN_KINDS = ("attn", "local", "global")
PORTED_KINDS = ATTN_KINDS + ("ssm",)

_FAMILIES_LATER = ("not ported yet; MLA, MoE, ring/SWA and RG-LRU come "
                   "with a later step of the port")


def _uses_ring(cfg: ModelConfig, kind: str) -> bool:
    return kind == "local" or (kind == "attn" and cfg.attn_kind == "swa")


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """Kind of every layer, in order (``cfg.pattern`` repeated)."""
    p = cfg.pattern
    return [p[i % len(p)] for i in range(cfg.n_layers)]


def stack_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(head, n_periods, tail) block counts of the JAX stack layout."""
    period = len(cfg.pattern)
    head = cfg.first_dense_layers
    rem = cfg.n_layers - head
    return head, rem // period, rem % period


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config this port cannot run yet."""
    if cfg.n_experts:
        raise NotImplementedError(f"MoE layers are {_FAMILIES_LATER}")
    if cfg.use_mla:
        raise NotImplementedError(f"MLA attention is {_FAMILIES_LATER}")
    if cfg.is_encoder_only or cfg.input_mode != "tokens":
        raise NotImplementedError(f"encoder-only and embedding-input models "
                                  f"are {_FAMILIES_LATER}")
    for kind in set(layer_kinds(cfg)):
        if kind not in PORTED_KINDS:
            raise NotImplementedError(f"layer kind {kind!r} is {_FAMILIES_LATER}")
        if _uses_ring(cfg, kind):
            raise NotImplementedError(f"sliding-window layers are "
                                      f"{_FAMILIES_LATER}")


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """Weights of one layer: ``ln1`` and ``mixer`` (the attention
    projections or the SSM mixer), then for attention kinds ``ln2`` and the
    SwiGLU ``mlp``; an SSM block has neither (``None``).  Inference only:
    the parameters do not require grad."""

    def __init__(self, kind: str, ln1: torch.Tensor, mixer: dict,
                 ln2: torch.Tensor | None = None, mlp: dict | None = None):
        super().__init__()
        self.kind = kind
        self.ln1 = _frozen(ln1)
        self.mixer = nn.ParameterDict({k: _frozen(v) for k, v in mixer.items()})
        self.ln2 = _frozen(ln2) if ln2 is not None else None
        self.mlp = (nn.ParameterDict({k: _frozen(v) for k, v in mlp.items()})
                    if mlp is not None else None)


def init_block(generator: torch.Generator, cfg: ModelConfig, kind: str,
               dtype, device) -> Block:
    """A freshly initialized layer of kind ``kind``."""
    d = cfg.d_model
    zeros = torch.zeros((d,), dtype=dtype, device=device)
    if kind == "ssm":
        return Block(kind, zeros, init_ssm(generator, cfg, dtype, device))
    mixer = init_attention(generator, cfg, dtype, device)
    mlp = init_mlp(generator, d, cfg.d_ff, dtype, device)
    return Block(kind, zeros, mixer, zeros.clone(), mlp)


def _mlp_residual(bp: Block, x, cfg: ModelConfig):
    if bp.mlp is None:
        return x
    h2 = rms_norm(x, bp.ln2, cfg.norm_eps)
    return x + mlp_forward(bp.mlp, h2).to(x.dtype)


def block_forward(bp: Block, x, cfg: ModelConfig, positions, *,
                  want_cache: bool, true_lens=None, impl: str | None = None):
    """Full-sequence block.  ``true_lens`` (B,) are the real lengths of
    right-padded rows (read by SSM layers; causal attention needs no mask
    for right padding).  Returns (x, the layer's cache or None)."""
    h = rms_norm(x, bp.ln1, cfg.norm_eps)
    cache = None
    if bp.kind == "ssm":
        out = ssm_forward(bp.mixer, h, cfg, true_lens=true_lens,
                          return_state=want_cache, impl=impl)
        mix, cache = out if want_cache else (out, None)
    elif want_cache:
        mix, cache = attn_forward(bp.mixer, h, cfg, bp.kind, positions,
                                  return_kv=True, impl=impl)
    else:
        mix = attn_forward(bp.mixer, h, cfg, bp.kind, positions, impl=impl)
    x = x + mix.to(x.dtype)
    return _mlp_residual(bp, x, cfg), cache


def block_decode(bp: Block, x, cache: dict, cache_pos, cfg: ModelConfig, *,
                 impl: str | None = None):
    """One-token decode through a block; ``cache`` is updated in place.
    Returns (x, cache)."""
    h = rms_norm(x, bp.ln1, cfg.norm_eps)
    if bp.kind == "ssm":
        mix, cache = ssm_decode(bp.mixer, h, cache, cfg)
    else:
        mix, cache = attn_decode(bp.mixer, h, cache, cache_pos, cfg, bp.kind,
                                 impl=impl)
    x = x + mix.to(x.dtype)
    return _mlp_residual(bp, x, cfg), cache


def init_stack(generator: torch.Generator, cfg: ModelConfig, dtype,
               device) -> nn.ModuleList:
    """Every layer of the stack, in order."""
    check_supported(cfg)
    return nn.ModuleList(init_block(generator, cfg, kind, dtype, device)
                         for kind in layer_kinds(cfg))


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, s_max: int,
                     dtype, device) -> dict:
    """Zero decode cache of one layer: ``{"k", "v"}`` of (batch, s_max, K,
    hd), or for an SSM layer ``{"ssm": (batch, H, P, N) f32, "conv":
    (batch, W-1, conv_dim)}``."""
    if kind == "ssm":
        return init_ssm_cache(cfg, batch, dtype, device)
    shape = (batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_stack_cache(cfg: ModelConfig, batch: int, s_max: int, dtype,
                     device) -> list[dict]:
    """Zero decode cache, one :func:`init_block_cache` per layer."""
    check_supported(cfg)
    return [init_block_cache(cfg, kind, batch, s_max, dtype, device)
            for kind in layer_kinds(cfg)]


def stack_forward(blocks: nn.ModuleList, x, cfg: ModelConfig, positions, *,
                  want_cache: bool = False, true_lens=None,
                  impl: str | None = None):
    """Returns (x, per-layer caches or None)."""
    caches = [] if want_cache else None
    for bp in blocks:
        x, c = block_forward(bp, x, cfg, positions, want_cache=want_cache,
                             true_lens=true_lens, impl=impl)
        if want_cache:
            caches.append(c)
    return x, caches


def stack_decode(blocks: nn.ModuleList, x, caches: list, cache_pos,
                 cfg: ModelConfig, *, impl: str | None = None):
    """One-token decode through the whole stack; every layer's cache is
    updated in place.  Returns (x, caches)."""
    for bp, cache in zip(blocks, caches):
        x, _ = block_decode(bp, x, cache, cache_pos, cfg, impl=impl)
    return x, caches
