"""Public wrapper of the paged decode-attention kernel.

Tensors on the CPU go through the plain version (``ref.py``); tensors on a
GPU launch ``csrc/paged_attention.cu`` or raise.  The kernel splits every
sequence into partitions of ``PARTITION`` tokens and merges their partial
softmax states (``ref.py::paged_attention_split_ref`` / ``merge_partials_ref``
spell out the arithmetic); one wrapper call is one counted launch, the merge
pass included.  G >= 2 query heads a KV head run on the tensor cores over
``GQA_PARTITION``-token partitions: bf16 rounds P to bf16 before P·V, f32
takes each product as three TF32 products of split operands, as
``ref.py::paged_attention_tiled_ref`` rounds either; G = 1 runs on the CUDA
cores.

Absorbed MLA decode passes keys of the latent ‖ rope row and, as values,
the view ``k_pages[..., :r]`` of the same rows, at one of the widths of
``MLA_SHAPES`` (deepseek-v2-lite's ``MLA_DIMS``, minicpm3-4b's (288,
256)): the kernel reads each row once for keys and values, and splits
sequences into ``MLA_PARTITION``-token partitions.  Both types run
on the tensor cores: bf16 rounds P to bf16 before P·V, f32 takes each
product as three TF32 products of split operands, and
``paged_attention_tiled_ref`` rounds as either does.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._build import DTYPE_CODES, CudaKernel, refuse_autograd, report_meta
from .ref import paged_attention_ref, paged_attention_split_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("paged_attention", "paged_attention_fwd",
                    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     _I, _I, _I, _I, ctypes.c_float, _P])
# keys and values of one width, pages of their own: 80 is h2o-danube-1.8b's,
# 256 gemma3-4b's
HEAD_DIMS = (64, 128, 80, 256)
# query heads a KV head; 2 to 16 (16: recurrentgemma-9b's MQA at hd 256) are
# the rows of one tensor-core M tile in either type, 1 runs the CUDA cores
GROUPS = (1, 2, 4, 8, 16)
# (key, value) widths of absorbed MLA decode and the query heads a KV head
# each takes: deepseek-v2-lite (latent 512 ‖ rope 64, 16 heads; 4 in the
# tests) and minicpm3-4b (latent 256 ‖ rope 32, 40 heads)
MLA_SHAPES = {(576, 512): (4, 16), (288, 256): (40,)}
MLA_DIMS = (576, 512)     # deepseek-v2-lite's
PARTITION = 256   # tokens per split; the kernel takes it as an argument
MLA_PARTITION = 128   # faster on the card than 64 (chip_smoke.py times both)
# G >= 2 (``paged_gqa_mma_kernel``, ``paged_gqa_tf32x3_kernel``): faster on
# the card, summed over chip_smoke.py's grouped cases of either type, than
# 64 and 256 (it times all three)
GQA_PARTITION = 128


def split_count(table_width: int, page: int) -> int:
    """Partitions of ``PARTITION`` tokens the kernel splits every sequence
    into: enough to cover the block table's ``table_width · page`` tokens.
    It depends on the table's shape alone, so the wrapper never copies
    ``seq_lens`` to the host (which would sync every decode step)."""
    return _splits(table_width, page, PARTITION)


def mla_split_count(table_width: int, page: int) -> int:
    """:func:`split_count` for MLA's ``MLA_PARTITION``-token partitions."""
    return _splits(table_width, page, MLA_PARTITION)


def partition_for(hd: int, hd_v: int, group: int, dtype) -> int:
    """Tokens a partition of the kernel that runs this instance: MLA's
    widths, ``group`` >= 2 query heads a KV head, or G = 1."""
    if (hd, hd_v) in MLA_SHAPES:
        return MLA_PARTITION
    if group > 1:
        return GQA_PARTITION
    return PARTITION


def _splits(table_width: int, page: int, partition: int) -> int:
    return max(1, -(-table_width * page // partition))


def paged_counts(B, H, K, hd, elem, lens, hd_v=None, page: int = 16) -> tuple:
    """(FLOPs, bytes) of one call over sequences of ``lens`` tokens: the
    K/V bytes of the tokens each holds (with ``hd_v``, MLA, each row once:
    the values are its first hd_v columns), q and out, and the
    ``page``-token pages' table entries; the FLOPs of both products."""
    tokens = int(np.sum(lens))
    pages = int(np.sum(-(-np.asarray(lens) // page)))
    if hd_v is None:
        nbytes = elem * (2 * tokens * K * hd + 2 * B * H * hd)
        flops = 4.0 * tokens * H * hd
    else:
        nbytes = elem * (tokens * K * hd + B * H * (hd + hd_v))
        flops = 2.0 * tokens * H * (hd + hd_v)
    return flops, nbytes + 4 * (pages + B)


def _meta(q, k_pages, v_pages, block_table):
    """Report the call on meta tensors to the active counters: seq_lens
    has no values there, so every sequence counts at the table's capacity
    (a decode cell's full cache)."""
    B, H, hd = q.shape
    _, page, K, _ = k_pages.shape
    hd_v = v_pages.shape[3]
    lens = [block_table.shape[1] * page] * B
    flops, nbytes = paged_counts(B, H, K, hd, q.element_size(), lens,
                                 None if hd_v == hd else hd_v, page)
    report_meta("paged_attention", flops, nbytes)


def paged_attention(q, k_pages, v_pages, block_table, seq_lens, *,
                    scale: float | None = None, impl: str | None = None):
    """q (B,H,hd); k_pages (P,page,K,hd), v_pages (P,page,K,hd_v);
    block_table (B,max_pages) i32; seq_lens (B,) i32 → (B,H,hd_v).  The
    kernel takes hd_v = hd in ``HEAD_DIMS`` with contiguous pages, or
    (hd, hd_v) in ``MLA_SHAPES`` with ``v_pages = k_pages[..., :hd_v]``.

    Sequence b attends to its first ``seq_lens[b]`` tokens, token t living in
    row ``t % page`` of page ``block_table[b, t // page]``.  The kernel
    needs ``seq_lens >= 1`` and in-range table entries (it does not read
    them back to check).  ``impl=None`` picks by device (CPU: plain
    version, CUDA: kernel); ``impl="plain"`` forces the plain version.
    Raises ``RuntimeError`` under autograd (``_build.refuse_autograd``)."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    refuse_autograd("paged_attention", q, k_pages, v_pages)
    if impl == "plain" or q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_table, seq_lens,
                                   scale=scale)
    if q.device.type == "meta":
        _meta(q, k_pages, v_pages, block_table)
        return q.new_empty((q.shape[0], q.shape[1], v_pages.shape[3]))
    _check(q, k_pages, v_pages, block_table, seq_lens)
    B, H, hd = q.shape
    _, page, K, _ = k_pages.shape
    hd_v = v_pages.shape[3]
    max_pages = block_table.shape[1]
    scale = hd ** -0.5 if scale is None else scale
    partition = partition_for(hd, hd_v, H // K, q.dtype)
    n_split = _splits(max_pages, page, partition)
    out = torch.empty((B, H, hd_v), dtype=q.dtype, device=q.device)
    # per (sequence, query head, partition): max, sum, unnormalised output
    partials = (torch.empty(B * H * n_split * (hd_v + 2), dtype=torch.float32,
                            device=q.device) if n_split > 1 else None)
    KERNEL.launch(q.device, q.data_ptr(), k_pages.data_ptr(),
                  v_pages.data_ptr(), block_table.data_ptr(),
                  seq_lens.data_ptr(), out.data_ptr(),
                  None if partials is None else partials.data_ptr(),
                  DTYPE_CODES[q.dtype], B, H, K, hd, hd_v, v_pages.stride(1),
                  page, max_pages, partition, n_split, float(scale))
    return out


def paged_attention_partials(q, k_pages, v_pages, block_table, seq_lens, *,
                             scale: float | None = None,
                             impl: str | None = None):
    """:func:`paged_attention`'s per-partition softmax states instead of
    its output, for a merge with other shards of the same sequences
    (decode over a cache whose sequence is sharded): ``m`` (B,H,n), the
    max of each partition's scores in the log2 domain (``score · scale ·
    log2(e)``), ``l`` (B,H,n), the sum of ``2^(score - m)``, and ``o``
    (B,H,n,hd_v), the unnormalised output, all f32; an empty partition
    has m = -inf, l = 0, o = 0.  ``ref.py::merge_partials_ref`` merges
    them.

    On a GPU it is one counted launch of the kernel with n >= 2
    partitions, whose split pass writes these states (the launcher's
    merge pass also writes an output, which is not read); on the CPU it
    is ``paged_attention_split_ref`` over one partition of the table's
    width (n = 1)."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    refuse_autograd("paged_attention", q, k_pages, v_pages)
    B, H, hd = q.shape
    _, page, K, _ = k_pages.shape
    hd_v = v_pages.shape[3]
    if impl == "plain" or q.device.type == "cpu":
        width = max(1, block_table.shape[1] * page)
        return paged_attention_split_ref(q, k_pages, v_pages, block_table,
                                         seq_lens, partition=width,
                                         scale=scale)
    max_pages = block_table.shape[1]
    partition = partition_for(hd, hd_v, H // K, q.dtype)
    n = max(2, _splits(max_pages, page, partition))
    f32 = dict(dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        _meta(q, k_pages, v_pages, block_table)
        return (torch.empty((B, H, n), **f32), torch.empty((B, H, n), **f32),
                torch.empty((B, H, n, hd_v), **f32))
    _check(q, k_pages, v_pages, block_table, seq_lens)
    scale = hd ** -0.5 if scale is None else scale
    out = torch.empty((B, H, hd_v), dtype=q.dtype, device=q.device)
    partials = torch.empty(B * H * n * (hd_v + 2), **f32)
    KERNEL.launch(q.device, q.data_ptr(), k_pages.data_ptr(),
                  v_pages.data_ptr(), block_table.data_ptr(),
                  seq_lens.data_ptr(), out.data_ptr(), partials.data_ptr(),
                  DTYPE_CODES[q.dtype], B, H, K, hd, hd_v, v_pages.stride(1),
                  page, max_pages, partition, n, float(scale))
    m = partials[:B * H * n].view(B, H, n)
    l = partials[B * H * n:2 * B * H * n].view(B, H, n)
    o = partials[2 * B * H * n:].view(B, H, n, hd_v)
    # an empty partition writes m = -inf and l = 0 but no o: its o is
    # whatever the buffer held (NaN, say), so it is zeroed here
    return m, l, torch.where((m == -np.inf)[..., None], 0.0, o)


def _check(q, k_pages, v_pages, block_table, seq_lens) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on CPU or CUDA tensors, got "
                         f"{q.device}")
    tensors = (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
               ("block_table", block_table), ("seq_lens", seq_lens))
    if any(t.device != q.device for _, t in tensors):
        raise ValueError("all inputs must be on one device")
    if (q.dim() != 3 or k_pages.dim() != 4 or v_pages.dim() != 4
            or v_pages.shape[:3] != k_pages.shape[:3]):
        raise ValueError(f"expected q (B,H,hd), k pages (P,page,K,hd) and v "
                         f"pages (P,page,K,hd_v), got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    B, H, hd = q.shape
    K = k_pages.shape[2]
    hd_v = v_pages.shape[3]
    mla = (hd, hd_v) in MLA_SHAPES
    groups = MLA_SHAPES[hd, hd_v] if mla else GROUPS
    if k_pages.shape[3] != hd or H % K or H // K not in groups:
        raise ValueError(f"q {tuple(q.shape)} and pages "
                         f"{tuple(k_pages.shape)} do not match, or H/K not "
                         f"in {groups}")
    if mla:
        if (v_pages.data_ptr() != k_pages.data_ptr()
                or v_pages.stride() != k_pages.stride()):
            raise ValueError("MLA values must be the view "
                             "k_pages[..., :hd_v] of the key rows")
    elif hd_v != hd or hd not in HEAD_DIMS:
        raise ValueError(f"head dims ({hd}, {hd_v}) not supported (have "
                         f"{HEAD_DIMS} for keys and values alike, and "
                         f"{tuple(MLA_SHAPES)})")
    if (block_table.dim() != 2 or block_table.shape[0] != B
            or tuple(seq_lens.shape) != (B,)):
        raise ValueError(f"expected block_table (B,max_pages) and seq_lens "
                         f"(B,), got {tuple(block_table.shape)}, "
                         f"{tuple(seq_lens.shape)}")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("block_table and seq_lens must be int32")
    if (q.dtype not in DTYPE_CODES or k_pages.dtype != q.dtype
            or v_pages.dtype != q.dtype):
        raise ValueError(f"q and pages must all be float32 or bfloat16, got "
                         f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    for name, t in tensors:
        if name == "v_pages" and mla:
            continue               # a view of k_pages, checked above
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
