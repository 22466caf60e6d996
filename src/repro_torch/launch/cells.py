"""Dry-run cell construction: (architecture × input shape) → a step on
meta DTensors, ported from the JAX package's ``launch/cells.py``.

A *cell* is one entry of the assignment matrix.  :func:`build_cell`
returns the step function and its arguments: weights, optimizer state,
batches and caches on the **meta** device (nothing is allocated), placed
under ``distributed.sharding.ShardingPolicy`` on the given mesh.  Running
the step under ``distributed.spmd.spmd`` and ``launch.op_count.OpCounter``
gives its per-rank counts (``launch/dryrun.py``).

Shapes (assignment):
    train_4k     seq 4096  × global_batch 256   -> train_step
    prefill_32k  seq 32768 × global_batch 32    -> prefill_step
    decode_32k   KV 32768  × global_batch 128   -> serve_step (1 new token)
    long_500k    KV 524288 × global_batch 1     -> serve_step (sub-quadratic
                                                   archs only; see skip map)

The steps' outputs are placed as JAX's cells place them (``out_shardings``):
logits batch over data and vocab over model, caches by ``cache_spec``,
with an explicit ``redistribute``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..configs import get_config, get_smoke_config, list_archs
from ..configs.base import ModelConfig
from ..distributed.sharding import (ShardingPolicy, batch_axes_for,
                                    distribute_batch, distribute_caches,
                                    distribute_opt_state, distribute_params)
from ..models.model import (decode_step, init_decode_caches, init_params,
                            prefill)
from ..models.moe import MoECtx
from ..training.optimizer import AdamWConfig, adamw_init
from ..training.train_loop import make_train_step

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}

ARCHS = [a for a in list_archs() if a != "llama2-13b"]


def skip_reason(cfg: ModelConfig, shape: str) -> Optional[str]:
    kind = SHAPES[shape]["kind"]
    if cfg.is_encoder_only and kind == "decode":
        return "encoder-only: no decode step"
    if shape == "long_500k" and not cfg.subquadratic:
        return "pure full-attention arch: no sub-quadratic path (DESIGN §5)"
    return None


def cell_matrix() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCHS for s in SHAPES]


@dataclass
class Cell:
    arch: str
    shape: str
    cfg: ModelConfig
    step_fn: Any               # callable
    args: tuple                # meta DTensors (and host values)
    policy: ShardingPolicy
    static_desc: dict


def _meta_batch(cfg: ModelConfig, B: int, S: int, with_labels: bool) -> dict:
    if cfg.input_mode == "embeddings":
        batch = {"embeddings": torch.empty((B, S, cfg.d_model),
                                           dtype=torch.bfloat16,
                                           device="meta")}
    else:
        batch = {"tokens": torch.empty((B, S), dtype=torch.int32,
                                       device="meta")}
    if with_labels:
        batch["labels"] = torch.empty((B, S), dtype=torch.int32,
                                      device="meta")
    return batch


def _place(t, pol: ShardingPolicy, spec: tuple):
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, pol.placements(spec))


def build_cell(arch: str, shape: str, mesh, *, moe_impl: str = "dropping",
               smoke: bool = False, remat: bool = True) -> Cell:
    """The cell's step and its meta arguments under ``mesh``.  Weights come
    from ``init_params`` on the meta device (no generator: nothing is
    drawn); the AdamW state mirrors them."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    sh = SHAPES[shape]
    S, B, kind = sh["seq"], sh["batch"], sh["kind"]
    if smoke:
        S, B = 32, 4
    baxes = batch_axes_for(mesh)
    moe = MoECtx(impl=moe_impl, mesh=mesh if moe_impl == "ep_a2a" else None,
                 batch_axes=baxes)
    desc = dict(kind=kind, seq=S, batch=B)

    if kind == "train":
        pol = ShardingPolicy(mesh, "train", cfg, batch_axes=baxes)
        params = init_params(cfg, None, device="meta", dtype=torch.float32)
        params.requires_grad_(True)
        opt = distribute_opt_state(adamw_init(params), pol)
        params = distribute_params(params, pol)
        batch = distribute_batch(_meta_batch(cfg, B, S, True), pol)
        step = make_train_step(cfg, AdamWConfig(), moe_impl=moe, remat=remat)
        return Cell(arch, shape, cfg, step, (params, opt, batch), pol, desc)

    pol = ShardingPolicy(mesh, "serve", cfg, batch_axes=baxes)
    params = distribute_params(
        init_params(cfg, None, device="meta", dtype=torch.bfloat16), pol)

    if kind == "prefill":
        batch = distribute_batch(_meta_batch(cfg, B, S, False), pol)

        def prefill_step(params, batch):
            logits, caches = prefill(params, batch, cfg, moe_impl=moe)
            logits = _place(logits, pol, pol.logits_spec(tuple(logits.shape)))
            if caches is not None:
                caches = [{k: _place(t, pol, pol.cache_spec(k, tuple(t.shape)))
                           for k, t in c.items()} for c in caches]
            return logits, caches
        return Cell(arch, shape, cfg, prefill_step, (params, batch), pol, desc)

    caches = distribute_caches(
        init_decode_caches(cfg, B, S, dtype=torch.bfloat16, device="meta"),
        pol)
    tokens = distribute_batch(
        {"tokens": torch.empty((B, 1), dtype=torch.int32, device="meta")},
        pol)["tokens"]

    def serve_step(params, tokens, caches, cache_pos):
        logits, caches = decode_step(params, tokens, caches, cache_pos, cfg,
                                     moe_impl=moe)
        return _place(logits, pol, pol.logits_spec(tuple(logits.shape))), \
            caches
    # the last position: every cache row is attended to
    return Cell(arch, shape, cfg, serve_step, (params, tokens, caches, S - 1),
                pol, desc)
