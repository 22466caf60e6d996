"""Per-rank FLOPs, bytes and collectives of a step, counted as it runs: the
port's counterpart of the JAX package's ``launch/hlo_analysis.py``.

``hlo_analysis.py`` re-derives the roofline inputs from XLA's optimized
HLO text; PyTorch emits no HLO, and an eager step materialises every op
it runs, so the port counts the ops themselves with :class:`OpCounter`, a
``TorchDispatchMode``:

* FLOPs: ``torch.utils.flop_counter``'s formulas (``flop_registry``, what
  ``FlopCounterMode`` counts by) for every op the step runs, plus each
  kernel wrapper's own count when it runs on meta tensors
  (``kernels/_build.py::report_meta``).
* Bytes moved: eager PyTorch materialises each op, so traffic is the sum,
  over the ops a step runs, of the operand and output bytes; views and
  allocations count nothing, an in-place op's output is its operand, and
  an indexing op (a gather, or a scatter into a cache) moves only the rows
  it touches.
* Collectives by kind (all-gather, all-reduce, reduce-scatter, all-to-all,
  broadcast), each with its count, its output bytes and its largest
  single output.

Everything is per rank.  ``FlopCounterMode`` sits above DTensor's dispatch
and sees the global shapes: a (256, 5120) × (5120, 13824) product on a (16,
16) mesh reports the whole product, 3.62e10.  The counter instead returns
``NotImplemented`` for an op on DTensors (as ``CommDebugMode`` does), so
that DTensor runs it as local ops on each rank's shards, with the
redistributions it needs, while the counter is still active: the counter
sees those local ops and their collectives, and counts each with its local
shapes.  The fake-tensor runs of DTensor's shape propagation are not
counted.  A step on DTensors runs as ``with OpCounter() as c, spmd():``.

``train_flops`` and ``llama2_train_flops`` give the closed forms the
counter is held against (model FLOPs, PaLM's count, and the FLOPs a
training step executes).
"""

from __future__ import annotations

from collections import defaultdict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels import _build

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "broadcast")
_COLL_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d",
                    "_c10d_functional_autograd", "_dtensor")
_NO_TRAFFIC = {"empty", "empty_like", "new_empty", "empty_strided",
               "new_empty_strided", "detach", "lift_fresh", "alias",
               "_local_scalar_dense", "wait_tensor", "set_"}


def _kind(op_name: str):
    """Collective kind of a functional or c10d op name, or None."""
    n = op_name.replace("allreduce", "all_reduce").replace(
        "allgather", "all_gather").replace("alltoall", "all_to_all")
    for key, kind in (("all_gather", "all-gather"),
                      ("reduce_scatter", "reduce-scatter"),
                      ("all_reduce", "all-reduce"),
                      ("all_to_all", "all-to-all"),
                      ("broadcast", "broadcast")):
        if key in n:
            return kind
    return None


# Ops that read only the rows they index (2 x their output: the rows read,
# the output written, plus the indices), and ops that write only the rows
# they index (their source read, the rows written, and for the
# accumulating ones the rows read first, plus the indices).
_GATHERS = {"index", "gather", "index_select", "embedding", "take",
            "take_along_dim"}
_SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "scatter",
             "scatter_", "index_copy", "index_copy_", "masked_scatter_"}
_ACCUMULATES = {"index_add", "index_add_", "scatter_add", "scatter_add_",
                "index_reduce", "index_reduce_", "scatter_reduce",
                "scatter_reduce_"}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _traffic(name: str, args, kwargs, out) -> int:
    """Bytes an op moves: its operands and its outputs (an in-place op's
    output is its first operand, counted once); indexing ops only the rows
    they touch."""
    ins = _tensors((args, kwargs))
    if name in _GATHERS:
        idx = sum(tensor_bytes(t) for t in ins[1:]
                  if not t.is_floating_point())
        return 2 * sum(tensor_bytes(t) for t in _tensors(out)) + idx
    if name in _SCATTERS or name in _ACCUMULATES:
        idx = sum(tensor_bytes(t) for t in ins[1:]
                  if not t.is_floating_point())
        src = sum(tensor_bytes(t) for t in ins[1:] if t.is_floating_point())
        return (3 if name in _ACCUMULATES else 2) * src + idx
    seen = {id(t) for t in ins}
    return (sum(tensor_bytes(t) for t in ins)
            + sum(tensor_bytes(t) for t in _tensors(out) if id(t) not in seen))


def tensor_bytes(t) -> int:
    """Bytes of a tensor's own storage on this rank (a DTensor's local
    shard)."""
    t = getattr(t, "_local_tensor", t)
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts this rank's FLOPs, bytes and collectives while active (see
    the module docstring).  ``kernels`` holds each kernel wrapper's meta
    launches, FLOPs and bytes; ``by_op`` the FLOPs by aten op."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = {k: {"count": 0, "bytes": 0, "max_bytes": 0}
                            for k in COLLECTIVE_KINDS}
        self.kernels = defaultdict(lambda: {"launches": 0, "flops": 0.0,
                                            "bytes": 0.0})
        self.by_op = defaultdict(float)

    def _kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels[name]
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def __enter__(self):
        _build.COUNT_SINKS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *args):
        _build.COUNT_SINKS.remove(self._kernel)
        return super().__exit__(*args)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented            # count DTensor's local ops
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator):
            return out
        flat = [t for t in tree_flatten((args, kwargs, out))[0]
                if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in flat):
            return out       # DTensor's shape propagation, not the step
        name = func._schema.name.split("::")[-1]
        if func.namespace in _COLL_NAMESPACES:
            kind = _kind(name)
            if kind is not None:
                c = self.collectives[kind]
                nbytes = sum(tensor_bytes(t) for t in _tensors(out))
                c["count"] += 1
                c["bytes"] += nbytes
                c["max_bytes"] = max(c["max_bytes"], nbytes)
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += f
            self.by_op[str(packet)] += f
        if not func.is_view and name not in _NO_TRAFFIC:
            self.bytes += _traffic(name, args, kwargs, out)
        return out

    def summary(self) -> dict:
        """FLOPs, bytes, collectives (with their total bytes) and kernels,
        as plain numbers."""
        coll = {k: dict(v) for k, v in self.collectives.items()}
        return {"flops": self.flops, "traffic_bytes": self.bytes,
                "collectives": coll,
                "collective_bytes": sum(v["bytes"] for v in coll.values()),
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "matmul_flops_by_op": dict(self.by_op)}


def local_bytes(tensors) -> int:
    """Bytes this rank holds of ``tensors`` (DTensors count their local
    shards)."""
    return sum(tensor_bytes(t) for t in tensors)


def train_flops(params, cfg, batch: int, seq: int) -> tuple:
    """(model FLOPs of one training step, FLOPs the step executes, matmul
    weights N a token reads).

    N is counted from the parameters: every block weight of two or more
    dims (projections, MLPs, routers, the depthwise convs: one
    multiply-add a weight a token each) and the head (the embedding is a
    lookup; a tied table counts once, as the head); an MoE block's routed
    experts (its three-dim weights) at ``top_k / n_experts``, its router and
    shared experts whole.  Model FLOPs: 6·N·tokens plus three times the
    forward products no weight counts (PaLM's count):

    * attention, a layer and a token: QKᵀ 2·T·H·dk and PV 2·T·H·dv over
      the whole span T = S, or a local layer's window min(W, S); MLA's dk
      = hd + rd, dv = vd, else dk = dv = hd;
    * the SSD, a layer and a token: the intra-chunk scores C·Bᵀ 2·Q·N a
      group, their product with x 2·Q·H·P, the chunk states and y_off
      2·H·P·N each (Q the chunk, whole chunks);
    * none for the RG-LRU scan (element-wise).

    Executed: 6·N·tokens (the forward and the backward) and 2·N′·tokens
    for the recompute under remat, plus the products as the step runs
    them, four times (the forward, its recompute, the backward twice):
    attention over the whole S x S below ``BLOCKWISE_THRESHOLD``, above it
    over each query block's KV span (S, or W + 512 for a window) and a
    fifth time for blockwise's query-block recompute; the SSD's products as
    counted above, since ``models/ssm.py::ssd_chunk_train`` also takes the
    scores once a group.  N′ leaves out the head (outside every
    checkpointed segment) and each segment's last product, whose output
    the backward does not keep, so that the non-reentrant checkpoint stops
    its recompute before it (``torch.utils.checkpoint``'s early stop): a
    dense MLP's ``w_down``, the shared experts' ``w_down``, an SSM block's
    ``out_proj``; an MoE block without shared experts keeps its last
    product, whose output its gates' gradient reads.  ``OpCounter`` counts
    this on meta tensors (``tests/test_torch_dryrun.py``)."""
    from ..models.attention import BLOCKWISE_THRESHOLD, window_for
    from ..models.transformer import stack_layout
    tokens = batch * seq
    n = params.head.numel() if params.head is not None else \
        params.embed.numel()
    skipped = n                  # the head, and each segment's last product
    head, n_periods, _ = stack_layout(cfg)
    period = len(cfg.pattern)
    ends = {i - 1 for i in [head] + [head + (p + 1) * period
                                     for p in range(n_periods)]
            + [len(params.blocks)] if i > 0}
    for i in sorted(ends):
        skipped += _last_product(params.blocks[i])
    attn_model = attn_exec = ssd_model = ssd_exec = 0
    dk = cfg.head_dim + (cfg.rope_head_dim if cfg.use_mla else 0)
    dv = cfg.v_head_dim
    for bp in params.blocks:
        for group in (bp.mixer, bp.mlp or {}, bp.shared or {}):
            for w in group.values():
                if w.dim() >= 2:
                    routed = bp.use_moe and group is bp.mlp and w.dim() == 3
                    n += (w.numel() * cfg.moe_top_k // cfg.n_experts
                          if routed else w.numel())
        if bp.kind == "ssm":
            Q, N, P = min(cfg.ssm_chunk, seq), cfg.ssm_state, cfg.ssm_head_dim
            H, G = cfg.n_ssm_heads, cfg.ssm_groups
            ssd_fwd = 2 * tokens * (Q * N * G + Q * H * P + 2 * H * P * N)
            ssd_model += ssd_fwd
            ssd_exec += 4 * ssd_fwd
        elif bp.kind != "rglru":
            win = window_for(cfg, bp.kind)
            span = min(win, seq) if win else seq
            a_tok = 2 * cfg.n_heads * (dk + dv)       # a key, a token
            attn_model += tokens * span * a_tok
            if seq > BLOCKWISE_THRESHOLD:
                kv = min(win + min(512, seq), seq) if win else seq
                attn_exec += 5 * tokens * kv * a_tok
            else:
                attn_exec += 4 * tokens * seq * a_tok
    return (6 * n * tokens + 3 * (attn_model + ssd_model),
            6 * n * tokens + 2 * (n - skipped) * tokens + attn_exec
            + ssd_exec, n)


def _last_product(bp) -> int:
    """Weights of a block's last product, which a checkpointed segment
    ending in the block does not recompute (see :func:`train_flops`)."""
    if bp.kind == "ssm":
        return bp.mixer["out_proj"].numel()
    if bp.shared is not None:
        return bp.shared["w_down"].numel()
    if bp.mlp is not None and not bp.use_moe:
        return bp.mlp["w_down"].numel()
    return 0


def llama2_train_flops(cfg, batch: int, seq: int) -> tuple:
    """The closed form for llama2 (dense d_ff, GQA projections, the
    whole causal span through blockwise), which :func:`train_flops` must
    reproduce from the parameters: every layer is a checkpointed segment,
    so the recompute leaves out the head and every layer's ``w_down``."""
    d, L = cfg.d_model, cfg.n_layers
    H, K, hd, ff = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    n = L * (d * H * hd * 2 + d * K * hd * 2 + 3 * d * ff) + d * cfg.vocab_size
    recomputed = n - d * cfg.vocab_size - L * d * ff
    attn_fwd = 4 * batch * seq * seq * H * hd * L
    tokens = batch * seq
    return (6 * n * tokens + 3 * attn_fwd,
            6 * n * tokens + 2 * recomputed * tokens + 5 * attn_fwd, n)
