"""Train-step factory, ported from the JAX package's
``training/train_loop.py``: the loss and its gradients through autograd,
then the AdamW update, with optional microbatch gradient accumulation (the
losses and gradients of splits of the leading batch dim summed, then
divided, as JAX's scan does)."""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..distributed.spmd import is_dtensor
from ..models.common import DtypePolicy
from ..models.model import LMParams, init_params, train_loss
from .optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update


def batch_to(batch: dict, device) -> dict:
    """A batch of numpy arrays (``TokenDataset.batches``) as tensors on
    ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _placed_as(g, p):
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    moe_impl: str = "dropping", num_microbatches: int = 1,
                    remat: bool = True,
                    policy: DtypePolicy = DtypePolicy.train()):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``: batch tensors with a leading dim of the global
    batch, parameters and moments updated in place, metrics ``loss`` and
    ``grad_norm`` (device tensors) and ``lr`` (a float).
    ``train_step.loss_and_grads(params, batch) -> (loss, grads)`` is the
    step's gradient function, each DTensor gradient placed as its
    weight."""

    def loss_and_grads(params: LMParams, batch: dict):
        weights = dict(params.named_parameters())
        loss = train_loss(params, batch, cfg, policy=policy, remat=remat,
                          moe_impl=moe_impl)
        grads = torch.autograd.grad(loss, list(weights.values()),
                                    allow_unused=True)
        # a weight the loss does not read (internvl2's table under
        # embedding inputs) has a zero gradient, as in JAX; a DTensor
        # gradient is reduced onto its weight's placements (reduce-scatter
        # for a sharded weight), as GSPMD places it
        return loss.detach(), {
            k: torch.zeros_like(p) if g is None else _placed_as(g, p)
            for (k, p), g in zip(weights.items(), grads)}

    def train_step(params: LMParams, opt_state: AdamWState, batch: dict):
        if num_microbatches <= 1:
            loss, grads = loss_and_grads(params, batch)
        else:
            mb = next(iter(batch.values())).shape[0] // num_microbatches
            loss, grads = None, None
            for i in range(num_microbatches):
                l, g = loss_and_grads(
                    params, {k: v[i * mb:(i + 1) * mb]
                             for k, v in batch.items()})
                if grads is None:
                    loss, grads = l, {k: t.float() for k, t in g.items()}
                else:
                    loss = loss + l
                    for k, t in g.items():
                        grads[k].add_(t)
            loss = loss / num_microbatches
            for t in grads.values():
                t.div_(num_microbatches)
        params, opt_state, metrics = adamw_update(grads, opt_state, params,
                                                  opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    train_step.loss_and_grads = loss_and_grads
    return train_step


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device="cuda", dtype=torch.float32):
    """Trainable random weights for ``cfg`` from ``generator`` (which lives
    on ``device``) and their zero AdamW state."""
    params = init_params(cfg, generator, device=device, dtype=dtype)
    params.requires_grad_(True)
    return params, adamw_init(params)
