"""Logical-axis sharding rules for every architecture and execution mode,
ported from the JAX package's ``distributed/sharding.py``, resolved into
DTensor placements.

Mesh axes
    single-pod : (data=16, model=16)
    multi-pod  : (pod=2, data=16, model=16)

Policies (resolved per tensor by name and shape, as in JAX):

  train  — batch over (pod?, data); FSDP: d_model rows of weights over
           "data"; TP: heads/ff/vocab over "model"; optimizer state mirrors
           parameter sharding (ZeRO-3).
  serve  — TP over "model"; weights replicated over data/pod, except archs
           in ``SERVE_FSDP_ARCHS`` (internvl2-76b), which also shard
           weights over "data".  Decode caches: batch over data (when
           divisible), the KV *sequence* over "model" (each shard computes
           partial softmax statistics; only small max/sum reductions cross
           ranks), falling back to the feature dim when the sequence does
           not divide; SSM and RG-LRU states over their head or last dim.

Every rule gives a per-dimension tuple of axis names, the form of JAX's
``PartitionSpec``: ``None`` (replicated), an axis name, or a tuple of axis
names (``("pod", "data")``).  :meth:`ShardingPolicy.placements` turns it
into DTensor placements: an axis on tensor dim i is ``Shard(i)`` on that
mesh dim (a tuple puts ``Shard(i)`` on each of its mesh dims, pod-major,
JAX's order), every other mesh dim ``Replicate()``.  A dim that does not
divide over its axis, or is smaller than it, stays replicated (minicpm3's
73,448-token vocabulary, mamba2's 50,280), as in JAX: DTensor would shard
it unevenly without a word.

Differences from the JAX rules, by layout only: the port keeps its layers
as a list (``bridge.layers_from_tree``), so no parameter carries JAX's
stacked period dim (its leading ``None``); an MLA layer's one slot cache
``"ckv"`` (B, S, 1, r + rd) takes the rule of JAX's ``"latent"`` and
``"k_rope"``: sequence over "model", else the feature dim.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..configs.base import ModelConfig

# Archs whose *serving* weights must also be FSDP-sharded over "data".
SERVE_FSDP_ARCHS = {"internvl2-76b"}


@dataclass(frozen=True)
class ShardingPolicy:
    """Sharding rules of one (mesh, mode, config).  ``mesh`` is a
    ``DeviceMesh`` or a ``launch.mesh.AbstractMesh`` (the rules read only
    its axis names and sizes; placements and distribution need a
    ``DeviceMesh``)."""

    mesh: object
    mode: str                      # "train" | "serve"
    cfg: ModelConfig
    batch_axes: tuple = ("data",)  # ("pod", "data") on the multi-pod mesh
    tp_axis: str = "model"
    fsdp_axis: Optional[str] = "data"

    def __post_init__(self):
        if self.mode == "serve" and self.cfg.name not in SERVE_FSDP_ARCHS:
            object.__setattr__(self, "fsdp_axis", None)

    # ---- helpers ----------------------------------------------------------

    @property
    def axis_sizes(self) -> dict:
        return dict(zip(self.mesh.mesh_dim_names, tuple(self.mesh.shape)))

    def _ax(self, axis: Optional[str], dim: int) -> Optional[str]:
        """Use ``axis`` only if the dim divides evenly over it."""
        if axis is None:
            return None
        size = self.axis_sizes[axis]
        return axis if dim % size == 0 and dim >= size else None

    def _batch(self, dim: int):
        sizes = 1
        for a in self.batch_axes:
            sizes *= self.axis_sizes[a]
        if dim % sizes == 0 and dim >= sizes:
            return (tuple(self.batch_axes) if len(self.batch_axes) > 1
                    else self.batch_axes[0])
        data = self.axis_sizes.get("data")
        if "data" in self.batch_axes and dim % data == 0 and dim >= data:
            return "data"
        return None

    # ---- parameter rules ---------------------------------------------------

    def param_spec(self, name: str, shape: tuple) -> tuple:
        """Spec of one parameter, by its name (the last part of a
        ``named_parameters()`` key: ``wq``, ``w_gate``, ``embed``, ...) and
        its shape."""
        name = name.rsplit(".", 1)[-1]
        core = tuple(shape)
        tp, fs = self.tp_axis, self.fsdp_axis
        if name == "embed":
            V, d = core
            return (self._ax(tp, V), self._ax(fs, d))
        if name == "head" and len(core) == 2:
            d, V = core
            return (self._ax(fs, d), self._ax(tp, V))
        if len(core) == 1:          # norms, biases, A_log, lam, ...
            return (None,)
        # MoE expert tensors (E, d_in, d_out)
        if name in ("w_gate", "w_up", "w_down") and len(core) == 3:
            e_ax = self._ax(tp, core[0])
            if name == "w_down":
                return (e_ax, None, self._ax(fs, core[2]))
            return (e_ax, self._ax(fs, core[1]), None)
        if name in ("router", "conv_w"):
            return (None, None)
        if name in ("wq", "wk", "wv", "w_gate", "w_up", "w_x_in", "w_gate_in",
                    "in_proj"):
            return (self._ax(fs, core[0]), self._ax(tp, core[1]))
        if name in ("wo", "w_down", "w_out", "out_proj"):
            return (self._ax(tp, core[0]), self._ax(fs, core[1]))
        if name == "w_dkv":
            return (self._ax(fs, core[0]), self._ax(tp, core[1]))
        if name == "w_krope":
            return (self._ax(fs, core[0]), None)
        if name in ("w_uk", "w_uv", "w_a", "w_i"):
            return (self._ax(tp, core[0]), None)
        return (None,) * len(core)

    # ---- activation / batch rules ----------------------------------------

    def batch_spec(self, shape: tuple) -> tuple:
        """A batch leaf (B, ...): batch over the batch axes."""
        if not shape:
            return ()
        return (self._batch(shape[0]),) + (None,) * (len(shape) - 1)

    def logits_spec(self, shape: tuple) -> tuple:
        """(B, S, V) logits: batch over data, vocab over model (kept
        sharded; sampling reduces it)."""
        return (self._batch(shape[0]), None, self._ax(self.tp_axis, shape[-1]))

    # ---- decode-cache rules -------------------------------------------------

    def cache_spec(self, name: str, shape: tuple) -> tuple:
        """Decode caches: k/v (B,S,K,hd) and MLA's ckv (B,S,1,r+rd) with S
        over tp (else the feature dim); ssm (B,H,P,N) with H over tp;
        conv/h states with their last dim over tp."""
        core = tuple(shape)
        tp = self.tp_axis
        b = self._batch(core[0])
        if name in ("k", "v", "ckv"):
            s_ax = self._ax(tp, core[1])
            f_ax = self._ax(tp, core[3]) if s_ax is None else None
            return (b, s_ax, None, f_ax)
        if name == "ssm":
            return (b, self._ax(tp, core[1]), None, None)
        if name in ("conv", "h"):
            return (b,) + (None,) * (len(core) - 2) + (self._ax(tp, core[-1]),)
        return (b,) + (None,) * (len(core) - 1)

    # ---- placements ----------------------------------------------------------

    def placements(self, spec: tuple) -> list:
        """DTensor placements of ``spec`` on this policy's mesh."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for axis in self.mesh.mesh_dim_names:
            dim = next((i for i, s in enumerate(spec)
                        if s == axis or (isinstance(s, tuple) and axis in s)),
                       None)
            out.append(Replicate() if dim is None else Shard(dim))
        return out

    def distribute(self, t: torch.Tensor, spec: tuple):
        """``t`` (the same whole tensor on every rank, or a meta tensor) as
        a DTensor under ``spec``: each rank keeps its own shard, nothing is
        sent.  Where every mesh dim that shards it has one rank, the DTensor
        wraps ``t`` itself (no copy)."""
        from torch.distributed.tensor import DTensor, Shard, distribute_tensor
        place = self.placements(spec)
        if all(self.mesh.size(i) == 1 for i, p in enumerate(place)
               if isinstance(p, Shard)):
            return DTensor.from_local(t, self.mesh, place, run_check=False,
                                      shape=t.shape, stride=t.stride())
        return distribute_tensor(t, self.mesh, place, src_data_rank=None)


def batch_axes_for(mesh) -> tuple:
    """("pod", "data") on a mesh with a pod axis, else ("data",)."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def _param(policy: ShardingPolicy, name: str, p: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(policy.distribute(p.detach(),
                                          policy.param_spec(name, p.shape)),
                        requires_grad=p.requires_grad)


def distribute_params(params, policy: ShardingPolicy):
    """A new ``models.model.LMParams`` whose every weight is a DTensor
    under ``policy.param_spec`` (the given one is left as it is)."""
    from ..models.model import LMParams
    from ..models.transformer import Block

    def each(d):
        return None if d is None else {k: _param(policy, k, v)
                                       for k, v in d.items()}
    blocks = nn.ModuleList()
    for bp in params.blocks:
        mlp = each(bp.mlp)
        if mlp is not None and bp.shared is not None:
            mlp["shared"] = each(bp.shared)
        blocks.append(Block(bp.kind, _param(policy, "ln1", bp.ln1),
                            each(bp.mixer),
                            None if bp.ln2 is None
                            else _param(policy, "ln2", bp.ln2), mlp))
    out = LMParams(blocks, _param(policy, "final_norm", params.final_norm),
                   None if params.embed is None
                   else _param(policy, "embed", params.embed),
                   None if params.head is None
                   else _param(policy, "head", params.head))
    # Block and LMParams wrap frozen; keep each weight's own flag
    for (_, new), (_, old) in zip(out.named_parameters(),
                                  params.named_parameters()):
        new.requires_grad_(old.requires_grad)
    return out


def distribute_opt_state(state, policy: ShardingPolicy):
    """An ``AdamWState`` whose moments are DTensors placed as their
    parameters (ZeRO-3); the step stays a host tensor."""
    from ..training.optimizer import AdamWState

    def each(d):
        return {k: policy.distribute(t, policy.param_spec(k, t.shape))
                for k, t in d.items()}
    return AdamWState(state.step, each(state.m), each(state.v))


def distribute_batch(batch: dict, policy: ShardingPolicy) -> dict:
    """Every batch leaf as a DTensor, batch over the batch axes."""
    return {k: policy.distribute(v, policy.batch_spec(tuple(v.shape)))
            for k, v in batch.items()}


def distribute_caches(caches: list, policy: ShardingPolicy) -> list:
    """Per-layer decode caches as DTensors under ``policy.cache_spec``."""
    return [{k: policy.distribute(t, policy.cache_spec(k, tuple(t.shape)))
             for k, t in c.items()} for c in caches]
