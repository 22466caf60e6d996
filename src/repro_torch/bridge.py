"""Carry weights and KV caches between the JAX package's layout and the
port's.

The JAX model keeps its layers as ``{"head": [..], "stack": {slot_i: ..},
"tail": [..]}``, where every ``stack`` leaf has a leading period axis (made
by ``jax.vmap`` over the periods of ``cfg.pattern``).  The port keeps one
entry per layer, in layer order.  These functions convert both ways for the
parameters (``repro.models.model.init_params`` layout) and the decode caches
(``repro.models.transformer.init_stack_cache`` layout).

Both sides of the bridge are numpy: it imports no JAX, and callers hand in
``np.asarray`` of the JAX arrays.  The conversion is exact.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .configs.base import ModelConfig
from .models.common import resolve_device
from .models.model import LMParams
from .models.transformer import Block, check_supported, layer_kinds, stack_layout


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _stack(trees: list):
    """Leafwise ``np.stack`` of structurally identical trees."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack([np.asarray(t) for t in trees])


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


def tree_from_layers(layers: list, cfg: ModelConfig) -> dict:
    """Inverse of :func:`layers_from_tree`."""
    head, n_periods, tail = stack_layout(cfg)
    period = len(cfg.pattern)
    out = {"head": layers[:head],
           "tail": layers[head + n_periods * period:]}
    if n_periods > 0:
        out["stack"] = {
            f"slot_{j}": _stack([layers[head + p * period + j]
                                 for p in range(n_periods)])
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
            ({k: _to_torch(v, dev) for k, v in bp["mlp"].items()}
             if has_mlp else None)))
    head = _to_torch(tree["head"], dev) if "head" in tree else None
    return LMParams(blocks, _to_torch(tree["final_norm"], dev),
                    _to_torch(tree["embed"], dev), head)


def params_to_numpy(params: LMParams, cfg: ModelConfig) -> dict:
    """Port parameters as the JAX package's parameter tree (numpy leaves)."""
    layers = []
    for bp in params.blocks:
        layer = {"ln1": _to_numpy(bp.ln1),
                 "mixer": {k: _to_numpy(v) for k, v in bp.mixer.items()}}
        if bp.mlp is not None:
            layer["ln2"] = _to_numpy(bp.ln2)
            layer["mlp"] = {k: _to_numpy(v) for k, v in bp.mlp.items()}
        layers.append(layer)
    out = {"blocks": tree_from_layers(layers, cfg),
           "final_norm": _to_numpy(params.final_norm),
           "embed": _to_numpy(params.embed)}
    if params.head is not None:
        out["head"] = _to_numpy(params.head)
    return out


def caches_from_jax(tree: dict, cfg: ModelConfig, *, device="cuda") -> list:
    """A JAX decode-cache tree (numpy leaves) as the port's per-layer list
    (``{"k", "v"}`` or ``{"ssm", "conv"}``) on ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    return [{k: _to_torch(v, dev) for k, v in layer.items()}
            for layer in layers_from_tree(tree, cfg)]


def caches_to_numpy(caches: list, cfg: ModelConfig) -> dict:
    """The port's per-layer caches as a JAX decode-cache tree (numpy)."""
    layers = [{k: _to_numpy(v) for k, v in layer.items()} for layer in caches]
    return tree_from_layers(layers, cfg)
