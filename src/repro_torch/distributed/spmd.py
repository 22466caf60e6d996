"""Running the port's models on DTensor parameters and batches.

The model code is written for plain tensors.  Under :func:`spmd`, the same
code runs with DTensor weights (``distributed.sharding``) and batches:
DTensor's own sharding rules place every op it has a rule for, and plain
tensors that the code makes on the way (positions, masks, zeros) count as
replicated (``implicit_replication``).  Where DTensor has no rule for an
op as its inputs stand, the model redistributes explicitly around it, the
way GSPMD inserts a gather: :func:`head_reshape` gathers a projection whose
heads do not divide over its ranks, and :func:`hold_batch` holds the
residual stream at its batch placement.  Any other op DTensor cannot place
raises.  Nothing runs on another device than the inputs'.

The paths that must not gather, or whose layout DTensor's rules cannot
see, call ``local_map`` with their own collectives: the kernels
(:func:`local_heads`), the vocab-parallel lookups (:func:`embed_lookup`,
:func:`label_logits`), decode over a sequence-sharded cache
(``models/attention.py::sharded_decode``) and the MoE dispatch
(``models/moe.py``).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

BATCH_AXES = ("pod", "data")


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


@contextmanager
def spmd():
    """Run model code on DTensors: plain tensors the code makes on the way
    count as replicated (``implicit_replication``).  An op DTensor cannot
    place raises, as DTensor does; the model redistributes explicitly
    where it needs to (:func:`head_reshape`, :func:`hold_batch`,
    :func:`local_heads`)."""
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        yield


def head_reshape(t, *shape, heads: int):
    """``t.reshape(*shape)``, a reshape that splits a dim into ``heads``
    heads or merges ``heads`` heads into one dim.  For a DTensor, the mesh
    dims that shard one of t's dims from the first one the reshape changes
    are made ``Replicate()`` first where ``heads`` does not divide over
    them: DTensor cannot split or merge a shard along heads that do not
    divide over its ranks (8 KV heads over 16 ranks, minicpm3's 40 query
    heads), and GSPMD gathers there too.  A pending sum (``Partial``) over
    such a mesh dim is reduced first as well."""
    if not is_dtensor(t):
        return t.reshape(*shape)
    from torch.distributed.tensor import Replicate, Shard
    first = next((i for i, (a, b) in enumerate(zip(t.shape, shape))
                  if a != b), min(t.ndim, len(shape)))
    over = {}
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim % t.ndim >= first:
            over.setdefault(p.dim % t.ndim, []).append(i)
    # a pending sum over such a mesh dim is reduced too: DTensor would
    # scatter it along the heads
    gather = {i for i, p in enumerate(t.placements)
              if p.is_partial() and heads % t.device_mesh.size(i)}
    for dims in over.values():
        n = 1
        for i in dims:
            n *= t.device_mesh.size(i)
        if heads % n:
            gather.update(dims)
    if gather:
        t = t.redistribute(t.device_mesh, [
            Replicate() if i in gather else p
            for i, p in enumerate(t.placements)])
    return t.reshape(*shape)


def replicated(t, mesh):
    """A plain tensor (the same on every rank) as a replicated DTensor;
    a DTensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor) or not isinstance(t, torch.Tensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _kv_slice(H: int, K: int, n: int):
    """For H query heads over n ranks and K KV heads that do not divide
    over them: whether each rank's H/n query heads read a whole number of
    KV heads (or share one), so that a rank can take its KV heads by a
    slice and keep one group size."""
    G, Hl = H // K, H // n
    return Hl % G == 0 or G % Hl == 0


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous.  An
    attention's backward can hand back a transposed gradient; DTensor's
    rule for the reshape behind it then views the local shard as if it
    were contiguous, and the view fails."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_heads(fn, q, *kv, head_dim: int = 2, tp_axis: str = "model",
                shared: tuple = ()):
    """``fn(q, *kv)`` on each rank's own batch rows and heads, through
    ``local_map``: the batch dim keeps q's batch sharding; the query heads
    (``head_dim``) are sharded over ``tp_axis`` when they divide over it.
    The KV heads are sharded alike when they divide too (each rank's query
    heads then read its own KV heads, the grouping unchanged); when they do
    not (8 KV heads over 16 ranks), each rank gets them whole and takes
    the slice its query heads read.  Otherwise every head is replicated.
    The inputs at the indices ``shared`` (counted from q = 0) hold one head
    that every query head reads (MLA's rope key) and stay whole.  The
    gradient of an input a rank reads only part of is summed over
    ``tp_axis``.  Returns fn's one output, placed as q; differentiable."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    names = mesh.mesh_dim_names or ()
    H = q.shape[head_dim]
    heads = [t.shape[head_dim] for i, t in enumerate(kv, 1)
             if i not in shared]
    place, kvp, kvg, one, one_grad = [], [], [], [], []
    cut = None                  # (rank on tp_axis, query heads a rank)
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        if isinstance(p, Shard) and p.dim == 0:
            row = [Shard(0)] * 5
        elif names[i] == tp_axis and H % n == 0 and all(
                k % n == 0 for k in heads):
            row = [Shard(head_dim)] * 3 + [Replicate(), Partial()]
        elif names[i] == tp_axis and H % n == 0 and all(
                _kv_slice(H, k, n) for k in heads):
            row = [Shard(head_dim), Replicate(), Partial(), Replicate(),
                   Partial()]
            cut = (mesh.get_local_rank(i), H // n)
        else:
            row = [Replicate()] * 5
        for lst, pl in zip((place, kvp, kvg, one, one_grad), row):
            lst.append(pl)

    def local(q_l, *kv_l):
        q_l, *kv_l = (_ContiguousGrad.apply(t) for t in (q_l, *kv_l))
        if cut is None:
            return fn(q_l, *kv_l)
        rank, Hl = cut
        out = []
        for i, t in enumerate(kv_l, 1):
            if i not in shared:
                G = H // t.shape[head_dim]
                lo, hi = rank * Hl // G, ((rank + 1) * Hl - 1) // G + 1
                t = t.narrow(head_dim, lo, hi - lo)
            out.append(t)
        return fn(q_l, *out)

    args = (q,) + tuple(replicated(t, mesh) for t in kv)
    ins = (place,) + tuple(one if i in shared else kvp
                           for i in range(1, len(args)))
    grads = (place,) + tuple(one_grad if i in shared else kvg
                             for i in range(1, len(args)))
    return local_map(local, out_placements=place, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def settle(t):
    """A DTensor with every pending reduction (``Partial`` placement, such
    as a vocab-parallel embedding's masked lookup) carried out now, so that
    the reduction happens once however often the value is read; any other
    tensor as it is."""
    from torch.distributed.tensor import Partial, Replicate
    if not is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in t.placements])


def _waited(t):
    import torch.distributed._functional_collectives as funcol
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def all_gather(t, group):
    """``t`` of every rank of ``group`` (a ``(mesh, mesh_dim)``),
    concatenated along dim 0 in rank order: a functional collective, which
    the dry run's counter sees."""
    import torch.distributed._functional_collectives as funcol
    fn = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
    return _waited(fn(t, 0, group))


def all_to_all(t, group):
    """Split ``t`` along dim 0 into equal parts, part j to rank j of
    ``group``; returns the parts received, in rank order (a functional
    ``all_to_all_single``, differentiable: its backward is the reverse
    exchange)."""
    import torch.distributed._functional_collectives as funcol
    return _waited(funcol.all_to_all_single_autograd(t, None, None, group))


def _shard_start(mesh, placements, dim: int, local_size: int) -> int:
    """First global index, along ``dim``, of this rank's shard."""
    from torch.distributed.tensor import Shard
    start = 0
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            start = start * mesh.size(i) + mesh.get_local_rank(i)
    return start * local_size


def _vocab_parallel(fn, idx, table, vocab_dim: int):
    """``fn(idx - start, table_shard, mine)`` on each rank through
    ``local_map``, the table sharded only along ``vocab_dim`` (its other
    dims gathered), ``idx`` keeping its batch sharding elsewhere; the ranks
    that shard the vocabulary sum their results (``Partial``), and the sum
    is taken at once (:func:`settle`)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    idx = replicated(idx, mesh)
    vd = vocab_dim % table.ndim
    tp = [p if isinstance(p, Shard) and p.dim == vd else Replicate()
          for p in table.placements]
    bp = [Shard(0) if isinstance(p, Shard) and p.dim == 0
          and not isinstance(t, Shard) else Replicate()
          for p, t in zip(idx.placements, tp)]
    if vd == 0:        # an embedding table: its rows' dims follow idx
        tp = [t if isinstance(t, Shard) else Replicate() for t in tp]
    else:              # logits: their batch dim follows idx
        tp = [t if isinstance(t, Shard) else b for t, b in zip(tp, bp)]
    out_p = [Partial() if isinstance(t, Shard) and t.dim == vd else b
             for t, b in zip(tp, bp)]
    # the table's gradient from each rank's own rows sums over the mesh
    # dims that shard the rows but not the table
    grad_p = [Partial() if isinstance(b, Shard) and not isinstance(t, Shard)
              else t for t, b in zip(tp, bp)]

    def local(i, tab):
        rows = tab.shape[vd]
        loc = i - _shard_start(mesh, tp, vd, rows)
        mine = (loc >= 0) & (loc < rows)
        return fn(loc.clamp(0, rows - 1), tab, mine)

    return settle(local_map(local, out_placements=out_p,
                            in_placements=(bp, tp),
                            in_grad_placements=(bp, grad_p),
                            device_mesh=mesh,
                            redistribute_inputs=True)(idx, table))


def embed_lookup(tokens, table):
    """``F.embedding(tokens, table)``; for a DTensor table, a
    vocab-parallel lookup: each rank looks up the tokens that fall in its
    rows of the table, zeros the rest, and the ranks sharding the
    vocabulary sum their lookups.  The rows keep the tokens' batch
    sharding."""
    import torch.nn.functional as F
    if not is_dtensor(table):
        return F.embedding(tokens, table)

    def fn(loc, tab, mine):
        x = F.embedding(loc, tab)
        return x * mine[..., None].to(x.dtype)
    return _vocab_parallel(fn, tokens, table, 0)


def label_logits(logits, labels):
    """``logits.gather(-1, labels[..., None])[..., 0]``; for DTensor
    logits sharded over the vocabulary, each rank takes the labels in its
    own columns and the ranks sum them."""
    if not is_dtensor(logits):
        return logits.gather(-1, labels[..., None])[..., 0]

    def fn(loc, lg, mine):
        return lg.gather(-1, loc[..., None])[..., 0] * mine.to(lg.dtype)
    return _vocab_parallel(fn, labels, logits, -1)


def _to_batch(t, batch_axes):
    from torch.distributed.tensor import Replicate, Shard
    names = t.device_mesh.mesh_dim_names or ()
    want = [p if type(p) is Shard and p.dim == 0 and names[i] in batch_axes
            else Replicate() for i, p in enumerate(t.placements)]
    if tuple(want) == tuple(t.placements):
        return t
    return t.redistribute(t.device_mesh, want)


class _HoldBatch(torch.autograd.Function):
    """:func:`hold_batch` whose backward holds the gradient at the same
    batch placement (a plain ``redistribute`` would send it back to the
    forward input's placement)."""

    @staticmethod
    def forward(ctx, t, batch_axes):
        ctx.batch_axes = batch_axes
        return _to_batch(t, batch_axes)

    @staticmethod
    def backward(ctx, g):
        return (_to_batch(g, ctx.batch_axes) if is_dtensor(g) else g), None


def hold_batch(t, batch_axes=BATCH_AXES):
    """A DTensor activation redistributed to its batch placement: sharded
    along dim 0 over the batch axes it is sharded over now, replicated
    over every other mesh dim (pending sums reduced); its gradient is held
    the same way.  The residual stream is held so at each block's adds,
    the explicit counterpart of the JAX package's activation pin: left
    alone, DTensor's rules can move a sequence or feature shard onto the
    "model" axis, where the next block's products then resolve slowly
    (strided shards) and gather more.  Any other tensor is returned as it
    is."""
    if not is_dtensor(t):
        return t
    return _HoldBatch.apply(t, tuple(batch_axes))
