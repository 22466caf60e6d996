"""Mixture-of-Experts layers (deepseek-v2-lite), ported from the JAX
package's ``models/moe.py``.

Two execution paths, selected by ``impl``:

* ``dense``    — every expert on every token, combined by router weights.
                 O(E·N·d·ff) compute: only for tiny smoke configs;
* ``dropping`` — Switch-style capacity dispatch: positions within each
                 expert from an exclusive cumsum of a one-hot in token-major
                 (token, choice) order, a scatter-add into (E, C, d) expert
                 buffers, batched expert products (``torch.bmm``, as the JAX
                 package leaves them to XLA) and a gather back.  The
                 engine's default.

Both share the router: softmax over expert logits in f32, top-k, gates
renormalised over the chosen k.  Tokens past an expert's capacity are
dropped (their gate is 0).  Nothing on either path reads a device value
back to the host, so a layer never synchronises the stream.

* ``ep_a2a``   — expert parallelism over a device mesh
                 (:func:`moe_ep_a2a`): the tokens sharded over the batch
                 axes, the experts over the expert axis; each rank routes
                 its own tokens at a capacity from its **local** token
                 count, as JAX does, and ships per-expert buckets with
                 ``all_to_all_single``.  It takes DTensors and the mesh of
                 a :class:`MoECtx`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from dataclasses import dataclass
from typing import Any

from ..configs.base import ModelConfig
from ..distributed.spmd import all_to_all, is_dtensor, replicated
from .common import dense_init


@dataclass(frozen=True)
class MoECtx:
    """How an MoE layer runs: ``impl`` (``dense``, ``dropping`` or
    ``ep_a2a``) and, for ``ep_a2a``, the mesh, the batch axes its tokens
    are sharded over and the axis its experts are sharded over (JAX's
    ``models/transformer.py::MoECtx`` without its activation pin
    ``x_spec``)."""

    impl: str = "dropping"
    mesh: Any = None
    batch_axes: tuple = ("data",)
    expert_axis: str = "model"


def init_moe(generator: torch.Generator, cfg: ModelConfig, dtype,
             device) -> dict:
    """Router (f32), per-expert SwiGLU weights (E, d, ff) / (E, ff, d) and,
    when the config has shared experts, their fused SwiGLU under
    ``"shared"``."""
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {"router": dense_init(generator, d, E, torch.float32, device),
         "w_gate": _expert_init(generator, E, d, ff, dtype, device),
         "w_up": _expert_init(generator, E, d, ff, dtype, device),
         "w_down": _expert_init(generator, E, ff, d, dtype, device)}
    if cfg.n_shared_experts:
        sff = cfg.moe_d_ff * cfg.n_shared_experts
        p["shared"] = {"w_gate": dense_init(generator, d, sff, dtype, device),
                       "w_up": dense_init(generator, d, sff, dtype, device),
                       "w_down": dense_init(generator, sff, d, dtype, device)}
    return p


def _expert_init(generator, E: int, d_in: int, d_out: int, dtype,
                 device) -> torch.Tensor:
    w = torch.randn((E, d_in, d_out), generator=generator,
                    dtype=torch.float32, device=device)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def _route(x2d: torch.Tensor, router: torch.Tensor, top_k: int):
    """x2d (N, d) → gates (N, k) f32 renormalised, idx (N, k) int64, probs
    (N, E) f32."""
    probs = torch.softmax(x2d.float() @ router.float(), dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, idx, probs


def aux_load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                          E: int) -> torch.Tensor:
    """Switch-style load-balancing loss of the training step: E times the
    sum over experts of the mean router probability and the share of
    tokens whose top-1 choice is that expert.  probs (N, E) and idx (N, k)
    as :func:`moe_forward` returns them, flattened over tokens."""
    me = probs.mean(0)
    ce = (idx[:, :1] == torch.arange(E, device=idx.device)).float().mean(0)
    return E * (me * ce).sum()


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: ``n·k/E·capacity_factor`` rounded up to 8, at
    least 8."""
    c = int(n_tokens * cfg.moe_top_k / max(cfg.n_experts, 1)
            * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def _shared_forward(sp, x2: torch.Tensor) -> torch.Tensor:
    h = F.silu(x2 @ sp["w_gate"]) * (x2 @ sp["w_up"])
    return h @ sp["w_down"]


# The capacity dispatch, in four steps that ``dropping``, its sharded form
# and ``ep_a2a`` share; they differ only in the capacity, the ranks' offsets
# and the collectives between the steps.

def _rank_in_expert(flat_e: torch.Tensor, E: int):
    """Each (token, choice) pair's rank within its expert in token-major
    order (an exclusive cumsum of a one-hot), and that one-hot (N·k, E)
    int32."""
    onehot = (flat_e[:, None] == torch.arange(
        E, device=flat_e.device)[None]).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=0, dtype=torch.int32)
           - onehot).gather(1, flat_e[:, None])[:, 0]
    return pos, onehot


def _dispatch(x2: torch.Tensor, k: int, keep, slot, n_slots: int):
    """The kept pairs' token rows summed into ``n_slots`` buffer rows at
    ``slot`` (N·k,); a dropped pair adds 0, so every row sums one real
    token at most."""
    xk = x2.repeat_interleave(k, dim=0)
    contrib = torch.where(keep[:, None], xk, torch.zeros_like(xk))
    return torch.zeros((n_slots, x2.shape[1]), dtype=x2.dtype,
                       device=x2.device).index_add(0, slot, contrib)


def _experts_ffn(xin, w_gate, w_up, w_down):
    """The experts' SwiGLU over their buffers: xin (E, C, d) → (E, C, d),
    batched products (``torch.bmm``, as the JAX package leaves them to
    XLA)."""
    h = torch.bmm(xin, w_gate)
    u = torch.bmm(xin, w_up)
    return torch.bmm(F.silu(h) * u, w_down)


def _combine(rows, slot, gates_flat, k: int, dtype):
    """Each pair's result row ``rows[slot]`` weighted by its gate (0 for a
    dropped pair), summed over its token's k choices: (N, d)."""
    y_tok = rows[slot].float() * gates_flat[:, None]
    return y_tok.view(-1, k, rows.shape[-1]).sum(1).to(dtype)


def moe_dense(params, x: torch.Tensor, cfg: ModelConfig):
    """Every expert on every token.  x (B,S,d) → (y (B,S,d), (probs,
    idx))."""
    B, S, d = x.shape
    x2 = x.reshape(-1, d)
    gates, idx, probs = _route(x2, params["router"], cfg.moe_top_k)
    h = torch.einsum("nd,edf->enf", x2, params["w_gate"])
    u = torch.einsum("nd,edf->enf", x2, params["w_up"])
    y_all = torch.einsum("enf,efd->end", F.silu(h) * u, params["w_down"])
    experts = torch.arange(cfg.n_experts, device=x.device)
    combine = ((idx[..., None] == experts).float()
               * gates[..., None]).sum(1)                       # (N, E)
    y = torch.einsum("end,ne->nd", y_all.float(), combine).to(x.dtype)
    if params.get("shared") is not None:
        y = y + _shared_forward(params["shared"], x2)
    return y.reshape(B, S, d), (probs, idx)


def moe_dropping(params, x: torch.Tensor, cfg: ModelConfig):
    """Capacity dispatch.  x (B,S,d) → (y (B,S,d), (probs, idx)).  The
    (token, choice) pairs are ranked within their expert in token-major
    order over all B·S rows (padding included), as in the JAX package; a
    pair ranked at or past the capacity is dropped."""
    B, S, d = x.shape
    N = B * S
    E, k = cfg.n_experts, cfg.moe_top_k
    C = _capacity(N, cfg)
    x2 = x.reshape(N, d)
    gates, idx, probs = _route(x2, params["router"], k)

    flat_e = idx.reshape(-1)                                    # (N·k,)
    pos, _ = _rank_in_expert(flat_e, E)
    keep = pos < C
    # a dropped pair goes to slot C - 1 of its expert, adding 0
    slot = flat_e * C + torch.where(keep, pos, C - 1).long()
    buf = _dispatch(x2, k, keep, slot, E * C).view(E, C, d)
    y_buf = _experts_ffn(buf, params["w_gate"], params["w_up"],
                         params["w_down"]).view(E * C, d)
    y = _combine(y_buf, slot, gates.reshape(-1) * keep.float(), k, x.dtype)
    if params.get("shared") is not None:
        y = y + _shared_forward(params["shared"], x2)
    return y.reshape(B, S, d), (probs, idx)


def _linear_rank(mesh, dims) -> tuple[int, int]:
    """(this rank's index, the count) over the mesh dims ``dims``, the
    first of them major."""
    idx, n = 0, 1
    for i in dims:
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
        n *= mesh.size(i)
    return idx, n


def moe_dropping_sharded(params, x, cfg: ModelConfig):
    """:func:`moe_dropping` on DTensors, the same numbers: each pair is
    ranked within its expert in token-major order over the **whole** batch
    and dropped at the capacity of the whole batch, as the single program
    does.  Routing runs on the DTensors (tokens keep their batch
    sharding); the dispatch runs through ``local_map``:

    * each batch rank ranks its own pairs, and all-gathers every batch
      rank's per-expert counts (E integers a rank) to offset them by the
      pairs of the batch ranks before it;
    * each rank fills, for the experts of its "model" rank, the capacity
      slots its own pairs hold (E_loc, C, d); a reduce-scatter over the
      batch axes gives each batch rank its 1/n_b of every local expert's
      slots, whole;
    * it runs its experts over those slots, all-gathers the results over
      the batch axes, and combines its own pairs' results by their gates.

    The output is a partial sum over "model" (each rank adds its experts'
    pairs), reduced by the caller's next hold.  Experts that do not divide
    over "model" are replicated there."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from ..distributed.spmd import all_gather, hold_batch

    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    x = hold_batch(x)
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    bdims = [i for i, p in enumerate(x.placements)
             if isinstance(p, Shard) and p.dim == 0]
    e_dim = names.index("model") if "model" in names else None
    if e_dim is not None and (E % mesh.size(e_dim) or e_dim in bdims):
        e_dim = None
    m_rank, n_m = (mesh.get_local_rank(e_dim), mesh.size(e_dim)) \
        if e_dim is not None else (0, 1)
    E_loc = E // n_m
    b_rank, n_b = _linear_rank(mesh, bdims)
    C = _capacity(B * S, cfg)
    C_pad = -(-C // n_b) * n_b           # whole slices of the slots
    # the routing input's gradient is held at the batch placement: left
    # alone, it comes back with its rows sharded over "model" as well,
    # which the reshape's backward to (B, S, d) cannot split
    gates, idx, probs = _route(hold_batch(x.reshape(B * S, d)),
                               params["router"], k)

    def gather_b(t):                     # over the batch dims, first major
        for i in reversed(bdims):
            t = all_gather(t, (mesh, i))
        return t

    def local_fn(x_l, gates_l, idx_l, w_gate, w_up, w_down):
        N_l = x_l.shape[0] * x_l.shape[1]
        x2 = x_l.reshape(N_l, d)
        flat_e = idx_l.reshape(-1)
        pos, onehot = _rank_in_expert(flat_e, E)
        if n_b > 1:         # pairs of the batch ranks before this one
            counts = gather_b(onehot.sum(0, dtype=torch.int32)[None])
            before = counts[:b_rank].sum(0, dtype=torch.int32)
            pos = pos + before[flat_e]
        local_e = flat_e - m_rank * E_loc
        mine = (pos < C) & (local_e >= 0) & (local_e < E_loc)
        slot = (local_e.clamp(0, E_loc - 1) * C_pad
                + torch.where(mine, pos, 0)).long()
        buf = _dispatch(x2, k, mine, slot, E_loc * C_pad)
        # (n_b, E_loc, C_pad / n_b, d): slice j of every expert's slots to
        # batch rank j, summed over the batch ranks that filled it
        buf = buf.view(E_loc, n_b, C_pad // n_b, d).transpose(0, 1)
        for i in bdims:
            buf = funcol.reduce_scatter_tensor_autograd(
                buf.contiguous().flatten(0, 1), "sum", 0, (mesh, i)).view(
                    -1, E_loc, C_pad // n_b, d)
        y = _experts_ffn(buf[0], w_gate, w_up, w_down)[None]
        for i in reversed(bdims):
            y = funcol.all_gather_tensor_autograd(y.contiguous(), 0,
                                                  (mesh, i))
        back = y.view(n_b, E_loc, C_pad // n_b, d).transpose(0, 1).reshape(
            E_loc * C_pad, d)
        return _combine(back, slot, gates_l.reshape(-1) * mine.float(), k,
                        x_l.dtype).view(x_l.shape)

    nd = mesh.ndim
    xp = [Shard(0) if i in bdims else Replicate() for i in range(nd)]
    part = [Shard(0) if i in bdims else Partial() if i == e_dim
            else Replicate() for i in range(nd)]
    wp = [Shard(0) if i == e_dim else Replicate() for i in range(nd)]
    wg = [Shard(0) if i == e_dim else Partial() if i in bdims
          else Replicate() for i in range(nd)]
    y = local_map(
        local_fn, out_placements=part,
        in_placements=(xp, xp, xp, wp, wp, wp),
        in_grad_placements=(part, part, xp, wg, wg, wg),
        device_mesh=mesh, redistribute_inputs=True)(
            x, gates.reshape(B, S, k), idx.reshape(B, S, k),
            params["w_gate"], params["w_up"], params["w_down"])
    if params.get("shared") is not None:
        y = y + _shared_forward(params["shared"],
                                x.reshape(-1, d)).reshape(B, S, d)
    return y, (probs, idx)


def moe_ep_a2a(params, x, cfg: ModelConfig, mesh, *,
               batch_axes=("data",), expert_axis: str = "model"):
    """Expert parallelism with explicit all-to-all dispatch (JAX's
    ``moe_ep_a2a``).  x (B,S,d) a DTensor (or a plain tensor, taken as
    replicated); the routed experts' weights DTensors whose expert dim is
    sharded over ``expert_axis`` (S_e ranks, E_loc = E / S_e experts
    each).

    Through ``local_map``, each rank takes its batch rows (x sharded over
    the mesh dims of ``batch_axes``, replicated over the others), routes
    its N_loc tokens, ranks each (token, choice) pair within its expert in
    token-major order at the capacity of N_loc tokens, and fills an (E, C,
    d) send buffer; ``all_to_all_single`` over the expert axis ships slice
    j (experts j·E_loc ..) to rank j, which runs its local experts over the
    S_e·C rows it got and ships the results back; the kept pairs are
    combined by their gates.  Returns (y (B,S,d), (probs (N,E), idx
    (N,k))), batch-sharded as x."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    E, k, d = cfg.n_experts, cfg.moe_top_k, cfg.d_model
    names = mesh.mesh_dim_names
    e_dim = names.index(expert_axis)
    S_e = mesh.size(e_dim)
    if E % S_e:
        raise ValueError(f"experts {E} must divide over axis size {S_e}")
    E_loc = E // S_e
    xp = [Shard(0) if n in batch_axes else Replicate() for n in names]
    ep = [Shard(0) if i == e_dim else Replicate() for i in range(len(names))]
    rep = [Replicate()] * len(names)

    def local_fn(x_loc, router, w_gate, w_up, w_down):
        B_loc, S, _ = x_loc.shape
        N = B_loc * S
        C = _capacity(N, cfg)                  # per expert, local view
        x2 = x_loc.reshape(N, d)
        gates, idx, probs = _route(x2, router, k)
        flat_e = idx.reshape(-1)
        pos, _ = _rank_in_expert(flat_e, E)
        keep = pos < C
        slot = flat_e * C + torch.where(keep, pos, C - 1).long()
        send = _dispatch(x2, k, keep, slot, E * C)
        # (S_e, E_loc, C, d): slice j to rank j; back as (source, E_loc, C, d)
        recv = all_to_all(send.view(S_e, E_loc, C, d), (mesh, e_dim))
        xin = recv.transpose(0, 1).reshape(E_loc, S_e * C, d)
        y = _experts_ffn(xin, w_gate, w_up, w_down)
        y = y.view(E_loc, S_e, C, d).transpose(0, 1).contiguous()
        back = all_to_all(y, (mesh, e_dim)).view(E * C, d)
        y_out = _combine(back, slot, gates.reshape(-1) * keep.float(), k,
                         x_loc.dtype)
        return y_out.view(B_loc, S, d), probs, idx

    args = [replicated(t, mesh) for t in (
        x, params["router"], params["w_gate"], params["w_up"],
        params["w_down"])]
    y, probs, idx = local_map(
        local_fn, out_placements=(xp, xp, xp),
        in_placements=(xp, rep, ep, ep, ep), device_mesh=mesh,
        redistribute_inputs=True)(*args)
    if params.get("shared") is not None:
        B, S, _ = x.shape
        y = y + _shared_forward(params["shared"],
                                x.reshape(-1, d)).reshape(B, S, d)
    return y, (probs, idx)


def moe_forward(params, x: torch.Tensor, cfg: ModelConfig,
                impl="dropping"):
    """The MoE layer by ``impl``: ``dense``, ``dropping``, or a
    :class:`MoECtx` (which ``ep_a2a`` needs, for its mesh).  Returns (y,
    (probs, idx))."""
    ctx = impl if isinstance(impl, MoECtx) else MoECtx(impl=impl)
    if ctx.impl == "dense":
        return moe_dense(params, x, cfg)
    if ctx.impl == "dropping":
        if is_dtensor(x):
            return moe_dropping_sharded(params, x, cfg)
        return moe_dropping(params, x, cfg)
    if ctx.impl == "ep_a2a":
        mesh = ctx.mesh if ctx.mesh is not None else (
            x.device_mesh if is_dtensor(x) else None)
        if mesh is None:
            raise ValueError("moe impl 'ep_a2a' needs a device mesh "
                             "(MoECtx.mesh, or DTensor inputs)")
        return moe_ep_a2a(params, x, cfg, mesh, batch_axes=ctx.batch_axes,
                          expert_axis=ctx.expert_axis)
    raise ValueError(f"unknown moe impl {ctx.impl!r}")
