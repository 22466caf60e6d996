"""Layer stack assembly for the attention, SSM and RG-LRU layer kinds, with
dense or MoE MLPs.

The JAX package runs ``head`` blocks, a ``jax.lax.scan`` over periods of
``cfg.pattern`` and ``tail`` blocks, with stacked period weights.  Here the
layers are an ``nn.ModuleList`` of per-layer :class:`Block`\\ s in layer
order and the scan is a Python loop; ``stack_layout`` and ``layer_kinds``
keep the JAX meaning.  The decode cache is a per-layer list of dicts,
updated in place by :func:`stack_decode`: ``{"k", "v"}`` for a GQA layer
(of s_max rows, or for a sliding-window layer a ring of min(window, s_max)
rows), ``{"ckv"}`` for an MLA layer, ``{"ssm", "conv"}`` for an SSM layer,
``{"h", "conv"}`` for an RG-LRU layer.  With
``cfg.n_experts`` every block after the first ``cfg.first_dense_layers``
carries an MoE MLP (``models/moe.py``), run by ``moe_impl`` (``dense`` or
``dropping``, the default).

Every layer kind of the JAX package is ported: the attention kinds (GQA
and MLA; sliding-window layers — ``attn_kind`` ``swa``, the ``local``
layers of ``local_global`` and of recurrentgemma's hybrid pattern — over
ring caches), MoE MLPs, the SSM kind and the RG-LRU kind.  Encoder-only
stacks (hubert: bidirectional attention, ``cfg.causal`` off, and GeLU MLPs
without a gate) run :func:`stack_forward` without a cache; stacks fed
embeddings (internvl2) are ordinary decoder stacks.  Chunked decode
(:func:`stack_chunk`) runs on stacks of attention layers without a ring,
GQA or MLA, fed tokens, and not encoder-only
(:func:`supports_chunked_decode`), each chunk's MoE MLP by ``moe_impl`` as
in a prefill.

Training (:func:`stack_train_forward`, what ``model.train_loss`` runs) takes
every layer kind: attention blocks (GQA or MLA) through the training
attention, SSM blocks through ``ssd_chunked`` and RG-LRU blocks through
their checkpointed scan, none of them through a kernel wrapper; the MoE
load-balancing losses summed; with ``remat`` each period of ``cfg.pattern``
under ``torch.utils.checkpoint``, and the head and tail blocks as one
segment each.  It reads :class:`BlockView`\\ s, the compute-dtype casts of
the blocks' weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..distributed.spmd import hold_batch
from .attention import (MLA_CACHE, attn_chunk_decode, attn_decode,
                        attn_forward, gqa_decode_ring, init_attention,
                        init_cache, ring_cache_from_prefill, window_for)
from .common import rms_norm
from .mlp import init_mlp, mlp_forward
from .moe import aux_load_balance_loss, init_moe, moe_forward
from .rglru import init_rglru, init_rglru_cache, rglru_decode, rglru_forward
from .ssm import init_ssm, init_ssm_cache, ssm_decode, ssm_forward

ATTN_KINDS = ("attn", "local", "global")
PORTED_KINDS = ATTN_KINDS + ("ssm", "rglru")
# Decode-cache entries with a sequence axis (axis 1), which a prefill fills
# up to its bucket's length
SEQ_CACHE_ENTRIES = ("k", "v", MLA_CACHE)


def uses_ring(cfg: ModelConfig, kind: str) -> bool:
    """True for a sliding-window GQA layer, whose decode cache is a ring."""
    return not cfg.use_mla and (
        kind == "local" or (kind == "attn" and cfg.attn_kind == "swa"))


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
    """Raise ``NotImplementedError`` for a config with a layer kind the JAX
    package does not have either."""
    for kind in set(layer_kinds(cfg)):
        if kind not in PORTED_KINDS:
            raise NotImplementedError(f"unknown layer kind {kind!r} (have "
                                      f"{PORTED_KINDS})")


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _frozen_dict(d: dict | None) -> nn.ParameterDict | None:
    if d is None:
        return None
    return nn.ParameterDict({k: _frozen(v) for k, v in d.items()})


class Block(nn.Module):
    """Weights of one layer: ``ln1`` and ``mixer`` (the attention
    projections, the SSM mixer or the RG-LRU block), then for attention and
    RG-LRU kinds ``ln2`` and the ``mlp``: a SwiGLU MLP (a GeLU one without
    ``w_gate`` in an encoder-only stack), or an MoE layer
    (``use_moe``: its ``mlp`` has a router) whose shared experts (the
    ``"shared"`` entry of the JAX tree) sit in ``shared``.  An SSM block has
    no ``ln2`` and no MLP (``None``).
    Built frozen (serving); ``requires_grad_(True)`` on the model makes the
    weights trainable (``training.init_train_state``)."""

    def __init__(self, kind: str, ln1: torch.Tensor, mixer: dict,
                 ln2: torch.Tensor | None = None, mlp: dict | None = None):
        super().__init__()
        self.kind = kind
        self.use_moe = mlp is not None and "router" in mlp
        self.ln1 = _frozen(ln1)
        self.mixer = _frozen_dict(mixer)
        self.ln2 = _frozen(ln2) if ln2 is not None else None
        mlp = dict(mlp) if mlp is not None else None
        shared = mlp.pop("shared", None) if mlp is not None else None
        self.mlp = _frozen_dict(mlp)
        self.shared = _frozen_dict(shared)

    def cast(self, fn) -> "BlockView":
        """The block's weights through ``fn`` (one tensor in, one out), as
        plain tensors: what the training forward reads."""
        def each(pd):
            return None if pd is None else {k: fn(v) for k, v in pd.items()}
        return BlockView(self.kind, self.use_moe, fn(self.ln1),
                         each(self.mixer),
                         None if self.ln2 is None else fn(self.ln2),
                         each(self.mlp), each(self.shared))


@dataclass
class BlockView:
    """A layer's weights as plain tensors with :class:`Block`'s fields:
    ``train_loss``'s compute-dtype casts, made inside the autograd graph."""

    kind: str
    use_moe: bool
    ln1: torch.Tensor
    mixer: dict
    ln2: torch.Tensor | None
    mlp: dict | None
    shared: dict | None


def _moe_params(bp) -> dict:
    """The MoE weights of a :class:`Block` or :class:`BlockView` as
    ``models/moe.py`` takes them (the JAX layout: router, experts and
    ``"shared"``)."""
    return {**bp.mlp, "shared": bp.shared}


def init_block(generator: torch.Generator, cfg: ModelConfig, kind: str,
               dtype, device, use_moe: bool = False) -> Block:
    """A freshly initialized layer of kind ``kind`` (with an MoE MLP when
    ``use_moe``; an encoder-only stack's MLPs have no gate, as in JAX)."""
    d = cfg.d_model
    zeros = torch.zeros((d,), dtype=dtype, device=device)
    if kind == "ssm":
        return Block(kind, zeros, init_ssm(generator, cfg, dtype, device))
    mixer = (init_rglru(generator, cfg, dtype, device) if kind == "rglru"
             else init_attention(generator, cfg, dtype, device))
    mlp = (init_moe(generator, cfg, dtype, device) if use_moe
           else init_mlp(generator, d, cfg.d_ff, dtype, device,
                         gated=not cfg.is_encoder_only))
    return Block(kind, zeros, mixer, zeros.clone(), mlp)


def _mlp_residual(bp, x, cfg: ModelConfig, moe_impl: str):
    """(x after the MLP's residual, the MoE router's (probs, idx) or
    None)."""
    if bp.mlp is None:
        return x, None
    h2 = rms_norm(x, bp.ln2, cfg.norm_eps)
    routed = None
    if bp.use_moe:
        y, routed = moe_forward(_moe_params(bp), h2, cfg, impl=moe_impl)
    else:
        y = mlp_forward(bp.mlp, h2)
    return hold_batch(x + y.to(x.dtype)), routed


def block_forward(bp: Block, x, cfg: ModelConfig, positions, *,
                  want_cache: bool, true_lens=None, impl: str | None = None,
                  moe_impl: str = "dropping"):
    """Full-sequence block.  ``true_lens`` (B,) are the real lengths of
    right-padded rows (read by SSM and RG-LRU layers, and by
    ``ring_cache_from_prefill`` for sliding-window layers; causal attention
    needs no mask for right padding, but an MoE layer routes the padding
    too, as the JAX package does).  Returns (x, the layer's cache or
    None)."""
    h = rms_norm(x, bp.ln1, cfg.norm_eps)
    cache = None
    if bp.kind == "ssm":
        out = ssm_forward(bp.mixer, h, cfg, true_lens=true_lens,
                          return_state=want_cache, impl=impl)
        mix, cache = out if want_cache else (out, None)
    elif bp.kind == "rglru":
        out = rglru_forward(bp.mixer, h, cfg, true_lens=true_lens,
                            return_state=want_cache)
        mix, cache = out if want_cache else (out, None)
    elif want_cache:
        mix, cache = attn_forward(bp.mixer, h, cfg, bp.kind, positions,
                                  return_kv=True, impl=impl)
        if uses_ring(cfg, bp.kind):
            cache = ring_cache_from_prefill(cache, window_for(cfg, bp.kind),
                                            true_lens)
    else:
        mix = attn_forward(bp.mixer, h, cfg, bp.kind, positions, impl=impl)
    x = hold_batch(x + mix.to(x.dtype))
    return _mlp_residual(bp, x, cfg, moe_impl)[0], cache


def block_train_forward(bp, x, cfg: ModelConfig, positions, *,
                        moe_impl: str = "dropping"):
    """Training forward of a block (a :class:`BlockView`), no cache: the
    training attention (``attn_forward(..., train=True)``), the SSM mixer
    through ``ssd_chunked`` (no MLP, as in JAX) or the RG-LRU block, then
    the MLP.  Returns (x, the MoE load-balancing loss, 0 for a dense MLP
    or none)."""
    h = rms_norm(x, bp.ln1, cfg.norm_eps)
    if bp.kind == "ssm":
        mix = ssm_forward(bp.mixer, h, cfg, train=True)
    elif bp.kind == "rglru":
        mix = rglru_forward(bp.mixer, h, cfg, train=True)
    else:
        mix = attn_forward(bp.mixer, h, cfg, bp.kind, positions, train=True)
    x, routed = _mlp_residual(bp, hold_batch(x + mix.to(x.dtype)), cfg,
                              moe_impl)
    if routed is None:
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    probs, idx = routed
    return x, aux_load_balance_loss(probs.reshape(-1, cfg.n_experts),
                                    idx.reshape(-1, cfg.moe_top_k),
                                    cfg.n_experts)


def block_decode(bp: Block, x, cache: dict, cache_pos, cfg: ModelConfig, *,
                 impl: str | None = None, moe_impl: str = "dropping"):
    """One-token decode through a block; ``cache`` is updated in place.
    Returns (x, cache)."""
    h = rms_norm(x, bp.ln1, cfg.norm_eps)
    if bp.kind == "ssm":
        mix, cache = ssm_decode(bp.mixer, h, cache, cfg)
    elif bp.kind == "rglru":
        mix, cache = rglru_decode(bp.mixer, h, cache, cfg)
    elif uses_ring(cfg, bp.kind):
        mix, cache = gqa_decode_ring(bp.mixer, h, cache, cache_pos, cfg,
                                     window=window_for(cfg, bp.kind),
                                     impl=impl)
    else:
        mix, cache = attn_decode(bp.mixer, h, cache, cache_pos, cfg, bp.kind,
                                 impl=impl)
    x = hold_batch(x + mix.to(x.dtype))
    return _mlp_residual(bp, x, cfg, moe_impl)[0], cache


def supports_chunked_decode(cfg: ModelConfig) -> bool:
    """True when every layer of the stack can run :func:`block_chunk` —
    chunked prefill or a prefill at an offset against a full-layout cache.
    Excludes ring-buffer (sliding-window/local) attention (a later chunk
    token overwrites the ring slot an earlier in-chunk query still needs),
    recurrent state (SSM and RG-LRU layers need strictly sequential scans),
    encoder-only stacks (no decode cache) and embedding inputs (a chunk is
    tokens), as the JAX package does."""
    if cfg.is_encoder_only or cfg.input_mode != "tokens":
        return False
    kinds = set(layer_kinds(cfg))
    if not all(k in ATTN_KINDS for k in kinds):
        return False
    return not any(uses_ring(cfg, k) for k in kinds)


def block_chunk(bp: Block, x, cache: dict, pos0, cfg: ModelConfig, *,
                impl: str | None = None, moe_impl: str = "dropping"):
    """C-token chunk decode through an attention block (x (B,C,d)); the
    cache is updated in place.  Returns (x, cache)."""
    if bp.kind not in ATTN_KINDS or uses_ring(cfg, bp.kind):
        raise ValueError(f"chunked decode unsupported for layer kind "
                         f"{bp.kind}")
    h = rms_norm(x, bp.ln1, cfg.norm_eps)
    mix, cache = attn_chunk_decode(bp.mixer, h, cache, pos0, cfg, bp.kind,
                                   impl=impl)
    x = x + mix.to(x.dtype)
    return _mlp_residual(bp, x, cfg, moe_impl)[0], cache


def init_stack(generator: torch.Generator, cfg: ModelConfig, dtype,
               device) -> nn.ModuleList:
    """Every layer of the stack, in order."""
    check_supported(cfg)
    # the JAX stack's head blocks (first_dense_layers) keep a dense MLP
    return nn.ModuleList(
        init_block(generator, cfg, kind, dtype, device,
                   use_moe=cfg.n_experts > 0 and i >= cfg.first_dense_layers)
        for i, kind in enumerate(layer_kinds(cfg)))


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, s_max: int,
                     dtype, device) -> dict:
    """Zero decode cache of one layer: ``attention.init_cache`` (``{"k",
    "v"}`` of s_max rows, or of min(window, s_max) for a sliding-window
    layer's ring; MLA's ``{"ckv"}``), for an SSM layer ``{"ssm": (batch,
    H, P, N) f32, "conv": (batch, W-1, conv_dim)}``, for an RG-LRU layer
    ``{"h": (batch, w) f32, "conv": (batch, W-1, w)}``."""
    if kind == "ssm":
        return init_ssm_cache(cfg, batch, dtype, device)
    if kind == "rglru":
        return init_rglru_cache(cfg, batch, dtype, device)
    w = window_for(cfg, kind)
    length = min(w, s_max) if uses_ring(cfg, kind) and w else s_max
    return init_cache(cfg, batch, length, dtype, device)


def init_stack_cache(cfg: ModelConfig, batch: int, s_max: int, dtype,
                     device) -> list[dict]:
    """Zero decode cache, one :func:`init_block_cache` per layer."""
    check_supported(cfg)
    return [init_block_cache(cfg, kind, batch, s_max, dtype, device)
            for kind in layer_kinds(cfg)]


def stack_forward(blocks: nn.ModuleList, x, cfg: ModelConfig, positions, *,
                  want_cache: bool = False, true_lens=None,
                  impl: str | None = None, moe_impl: str = "dropping"):
    """Returns (x, per-layer caches or None)."""
    caches = [] if want_cache else None
    for bp in blocks:
        x, c = block_forward(bp, x, cfg, positions, want_cache=want_cache,
                             true_lens=true_lens, impl=impl,
                             moe_impl=moe_impl)
        if want_cache:
            caches.append(c)
    return x, caches


def stack_decode(blocks: nn.ModuleList, x, caches: list, cache_pos,
                 cfg: ModelConfig, *, impl: str | None = None,
                 moe_impl: str = "dropping"):
    """One-token decode through the whole stack; every layer's cache is
    updated in place.  Returns (x, caches)."""
    for bp, cache in zip(blocks, caches):
        x, _ = block_decode(bp, x, cache, cache_pos, cfg, impl=impl,
                            moe_impl=moe_impl)
    return x, caches


def stack_chunk(blocks: nn.ModuleList, x, caches: list, pos0,
                cfg: ModelConfig, *, impl: str | None = None,
                moe_impl: str = "dropping"):
    """Chunked decode through the whole stack (x (B,C,d)); every layer's
    cache is updated in place.  Returns (x, caches)."""
    for bp, cache in zip(blocks, caches):
        x, _ = block_chunk(bp, x, cache, pos0, cfg, impl=impl,
                           moe_impl=moe_impl)
    return x, caches


def _train_segment(blocks: list, x, cfg: ModelConfig, positions,
                   moe_impl: str):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for bp in blocks:
        x, a = block_train_forward(bp, x, cfg, positions, moe_impl=moe_impl)
        aux = aux + a
    return x, aux


def stack_train_forward(blocks: list, x, cfg: ModelConfig, positions, *,
                        moe_impl: str = "dropping", remat: bool = False):
    """Training forward through :class:`BlockView`\\ s in layer order.
    Returns (x, the summed MoE load-balancing loss).  With ``remat`` each
    period (``len(cfg.pattern)`` consecutive blocks after the head blocks)
    runs under ``torch.utils.checkpoint`` (non-reentrant): the backward
    keeps one carry a period and recomputes the period's activations, as
    the JAX stack checkpoints its period function.  The head blocks
    (deepseek's dense first layer) and the tail blocks (recurrentgemma's
    two RG-LRU layers past its last whole period) are one checkpointed
    segment each, where JAX keeps their activations: the numbers are the
    same, and a cut model's tail no longer holds its activations through
    the whole backward."""
    head, n_periods, _ = stack_layout(cfg)
    period = len(cfg.pattern)
    bounds = ([0, head] + [head + (p + 1) * period for p in range(n_periods)]
              + [len(blocks)])
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo, hi in zip(bounds, bounds[1:]):
        if lo == hi:
            continue
        fn = partial(_train_segment, blocks[lo:hi], cfg=cfg,
                     positions=positions, moe_impl=moe_impl)
        x, aux = (checkpoint(fn, x, use_reentrant=False) if remat
                  else fn(x))
        aux_total = aux_total + aux
    return x, aux_total
