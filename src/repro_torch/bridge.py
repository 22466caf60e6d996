"""Carry weights and KV caches between the JAX package's layout and the
port's.

The JAX model keeps its layers as ``{"head": [..], "stack": {slot_i: ..},
"tail": [..]}``, where every ``stack`` leaf has a leading period axis (made
by ``jax.vmap`` over the periods of ``cfg.pattern``).  The port keeps one
entry per layer, in layer order.  These functions convert both ways for the
parameters (``repro.models.model.init_params`` layout), the decode caches
(``repro.models.transformer.init_stack_cache`` layout) and the engines'
radix KV blocks (a cache tree whose batch and sequence axes are replaced by
a block's rows).  An MoE layer's shared experts stay under the ``"shared"``
key of its ``mlp`` on the JAX side and sit in the port block's ``shared``;
an MLA layer's ``{"latent", "k_rope"}`` cache pair is the port's one
``{"ckv"}`` tensor, the two joined along the last axis under a KV-head axis
of 1.  A sliding-window layer's ring ``{"k", "v"}`` (min(window, s_max)
slots, position p at slot p % W) has the same layout on both sides, so it
crosses as a full cache does; in gemma3's stack, layer j of period p is
layer ``head + p·6 + j``, global and local layers interleaved.  An RG-LRU
layer's weights (9 leaves, gate biases and Λ in f32) and its ``{"h",
"conv"}`` cache have one layout on both sides; recurrentgemma-9b's 38
layers are 12 periods of (rglru, rglru, local) and a tail of 2 RG-LRU
layers, which the ``tail`` list holds.  An encoder-only model fed
embeddings (hubert) has no ``"embed"`` in its tree, only ``"head"``, and
its GeLU MLPs no ``w_gate``.

The AdamW state crosses too (:func:`opt_state_to_numpy`,
:func:`opt_state_from_jax`): its moments are trees like the parameters, on
the port's side dicts keyed as ``named_parameters()``.
:func:`train_state_tree` lays a port training state out as the JAX
package's ``(params, AdamWState)`` tree with the port's own tensors as
leaves (the stacked period layers as ``checkpoint.Stacked`` leaves), which
is what a checkpoint saves.

Both sides of the bridge are numpy: it imports no JAX, and callers hand in
``np.asarray`` of the JAX arrays.  The conversion is exact.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .checkpoint import Stacked
from .configs.base import ModelConfig
from .models.common import resolve_device
from .models.model import LMParams
from .models.attention import MLA_CACHE
from .models.transformer import Block, check_supported, layer_kinds, stack_layout
from .training.optimizer import AdamWState


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _np_stack(leaves: list) -> np.ndarray:
    return np.stack([np.asarray(t) for t in leaves])


def _stack(trees: list, stack=_np_stack):
    """Leafwise ``stack`` of structurally identical trees."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees], stack) for k in first}
    return stack(trees)


def layers_from_tree(tree: dict, cfg: ModelConfig) -> list:
    """Per-layer subtrees, in layer order, of a ``{head, stack, tail}`` tree
    (the period axis of ``stack`` leaves unstacked)."""
    head, n_periods, tail = stack_layout(cfg)
    layers = list(tree["head"][:head])
    for p in range(n_periods):
        for j in range(len(cfg.pattern)):
            layers.append(_map(lambda a: np.asarray(a)[p],
                               tree["stack"][f"slot_{j}"]))
    layers.extend(tree["tail"][:tail])
    return layers


def tree_from_layers(layers: list, cfg: ModelConfig, stack=_np_stack) -> dict:
    """Inverse of :func:`layers_from_tree`; ``stack`` makes a period-stacked
    leaf of the layers' leaves (``np.stack`` by default)."""
    head, n_periods, tail = stack_layout(cfg)
    period = len(cfg.pattern)
    out = {"head": layers[:head],
           "tail": layers[head + n_periods * period:]}
    if n_periods > 0:
        out["stack"] = {
            f"slot_{j}": _stack([layers[head + p * period + j]
                                 for p in range(n_periods)], stack)
            for j in range(period)}
    return out


def _to_torch(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind != "f" or a.dtype.itemsize < 2:
        raise ValueError(f"the bridge carries numpy float16/32/64 arrays; got "
                         f"{a.dtype} (cast bfloat16 to float32 first)")
    return torch.from_numpy(np.array(a)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def params_from_jax(tree: dict, cfg: ModelConfig, *,
                    device="cuda") -> LMParams:
    """The JAX package's parameter tree (numpy leaves) as port parameters
    on ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    blocks = nn.ModuleList()
    for kind, bp in zip(layer_kinds(cfg), layers_from_tree(tree["blocks"], cfg)):
        has_mlp = "mlp" in bp                  # SSM blocks have no ln2/mlp
        blocks.append(Block(
            kind, _to_torch(bp["ln1"], dev),
            {k: _to_torch(v, dev) for k, v in bp["mixer"].items()},
            _to_torch(bp["ln2"], dev) if has_mlp else None,
            _map(lambda a: _to_torch(a, dev), bp["mlp"]) if has_mlp else None))
    embed = _to_torch(tree["embed"], dev) if "embed" in tree else None
    head = _to_torch(tree["head"], dev) if "head" in tree else None
    return LMParams(blocks, _to_torch(tree["final_norm"], dev), embed, head)


def params_to_numpy(params: LMParams, cfg: ModelConfig) -> dict:
    """Port parameters as the JAX package's parameter tree (numpy leaves)."""
    return named_to_numpy(dict(params.named_parameters()), cfg)


def named_to_numpy(named: dict, cfg: ModelConfig) -> dict:
    """Tensors keyed as ``LMParams.named_parameters()`` (weights, their
    gradients or AdamW moments) as the JAX parameter tree, numpy."""
    return _jax_layout(named, cfg, _to_numpy)


def _jax_layout(named: dict, cfg: ModelConfig, leaf, stack=_np_stack) -> dict:
    """A dict keyed as ``LMParams.named_parameters()`` (``blocks.3.mixer.wq``,
    ``blocks.3.shared.w_up``, ``embed``, ...) as the JAX parameter tree,
    each value through ``leaf``."""
    layers = [{} for _ in range(cfg.n_layers)]
    out = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] != "blocks":
            out[name] = leaf(t)
            continue
        layer = layers[int(parts[1])]
        if len(parts) == 3:                                 # ln1, ln2
            layer[parts[2]] = leaf(t)
        elif parts[2] == "shared":             # under mlp, as in JAX
            layer.setdefault("mlp", {}).setdefault("shared", {})[
                parts[3]] = leaf(t)
        else:
            layer.setdefault(parts[2], {})[parts[3]] = leaf(t)
    out["blocks"] = tree_from_layers(layers, cfg, stack)
    return out


def _named_from_tree(tree: dict, cfg: ModelConfig, leaf) -> dict:
    """Inverse of :func:`_jax_layout`."""
    out = {}
    for i, layer in enumerate(layers_from_tree(tree["blocks"], cfg)):
        for k, v in layer.items():
            if not isinstance(v, dict):
                out[f"blocks.{i}.{k}"] = leaf(v)
                continue
            for k2, v2 in v.items():
                if isinstance(v2, dict):                  # mlp.shared
                    out.update({f"blocks.{i}.{k2}.{k3}": leaf(v3)
                                for k3, v3 in v2.items()})
                else:
                    out[f"blocks.{i}.{k}.{k2}"] = leaf(v2)
    out.update({k: leaf(v) for k, v in tree.items() if k != "blocks"})
    return out


def opt_state_to_numpy(state: AdamWState, cfg: ModelConfig) -> AdamWState:
    """The port's AdamW state as the JAX package's (numpy leaves)."""
    return AdamWState(np.asarray(state.step.cpu().numpy(), dtype=np.int32),
                      named_to_numpy(state.m, cfg),
                      named_to_numpy(state.v, cfg))


def opt_state_from_jax(state, cfg: ModelConfig, *,
                       device="cuda") -> AdamWState:
    """The JAX package's AdamW state ``(step, m, v)`` (numpy leaves) as the
    port's, its moments on ``device`` keyed as ``named_parameters()``."""
    dev = resolve_device(device)
    step, m, v = state
    return AdamWState(torch.tensor(int(np.asarray(step)), dtype=torch.int32),
                      _named_from_tree(m, cfg, lambda a: _to_torch(a, dev)),
                      _named_from_tree(v, cfg, lambda a: _to_torch(a, dev)))


def train_state_tree(params: LMParams, state: AdamWState,
                     cfg: ModelConfig) -> tuple:
    """``(params, AdamWState)`` laid out as the JAX package's tree, its
    leaves the port's own tensors (no copy) and its period-stacked leaves
    ``checkpoint.Stacked``: what ``save_checkpoint`` and
    ``restore_checkpoint`` take for a training state."""
    def lay(named):
        return _jax_layout(named, cfg, lambda t: t, Stacked)
    return (lay(dict(params.named_parameters())),
            AdamWState(state.step, lay(state.m), lay(state.v)))


def caches_from_jax(tree: dict, cfg: ModelConfig, *, device="cuda") -> list:
    """A JAX decode-cache tree (numpy leaves) as the port's per-layer list
    (``{"k", "v"}``, ``{"ckv"}``, ``{"ssm", "conv"}`` or ``{"h", "conv"}``)
    on ``device``.  A
    radix KV block of the JAX engine (its ``export_prefix_blocks``: the
    cache tree with (block_size, K, hd) leaves) converts the same way, into
    the block layout of the port engine's ``import_prefix_blocks``."""
    check_supported(cfg)
    dev = resolve_device(device)
    out = []
    for layer in layers_from_tree(tree, cfg):
        if "latent" in layer:      # MLA: latent ‖ k_rope under one KV head
            layer = {MLA_CACHE: np.concatenate(
                [np.asarray(layer["latent"]), np.asarray(layer["k_rope"])],
                axis=-1)[..., None, :]}
        out.append({k: _to_torch(v, dev) for k, v in layer.items()})
    return out


def caches_to_numpy(caches: list, cfg: ModelConfig) -> dict:
    """The port's per-layer caches (or one radix KV block) as a JAX
    decode-cache tree (or block tree), numpy."""
    layers = []
    for layer in caches:
        layer = {k: _to_numpy(v) for k, v in layer.items()}
        if MLA_CACHE in layer:
            ckv = layer.pop(MLA_CACHE)[..., 0, :]
            r = cfg.kv_lora_rank
            layer = {"latent": ckv[..., :r].copy(),
                     "k_rope": ckv[..., r:].copy()}
        layers.append(layer)
    return tree_from_layers(layers, cfg)

