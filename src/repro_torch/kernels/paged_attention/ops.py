"""Public wrapper of the paged decode-attention kernel.

Tensors on the CPU go through the plain version (``ref.py``); tensors on a
GPU launch ``csrc/paged_attention.cu`` or raise.  The kernel splits every
sequence into partitions of ``PARTITION`` tokens and merges their partial
softmax states (``ref.py::paged_attention_split_ref`` / ``merge_partials_ref``
spell out the arithmetic); one wrapper call is one counted launch, the merge
pass included.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import DTYPE_CODES, CudaKernel
from .ref import paged_attention_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("paged_attention", "paged_attention_fwd",
                    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     _I, _I, ctypes.c_float, _P])
HEAD_DIMS = (64, 128)
GROUPS = (1, 2, 4, 8)
PARTITION = 256   # tokens per split; the kernel takes it as an argument


def split_count(table_width: int, page: int) -> int:
    """Partitions of ``PARTITION`` tokens the kernel splits every sequence
    into: enough to cover the block table's ``table_width · page`` tokens.
    It depends on the table's shape alone, so the wrapper never copies
    ``seq_lens`` to the host (which would sync every decode step)."""
    return max(1, -(-table_width * page // PARTITION))


def paged_attention(q, k_pages, v_pages, block_table, seq_lens, *,
                    scale: float | None = None, impl: str | None = None):
    """q (B,H,hd); k/v_pages (P,page,K,hd); block_table (B,max_pages) i32;
    seq_lens (B,) i32 → (B,H,hd).

    Sequence b attends to its first ``seq_lens[b]`` tokens, token t living in
    row ``t % page`` of page ``block_table[b, t // page]``.  The kernel
    needs ``seq_lens >= 1`` and in-range table entries (it does not read
    them back to check).  ``impl=None`` picks by device (CPU: plain
    version, CUDA: kernel); ``impl="plain"`` forces the plain version."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    if impl == "plain" or q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_table, seq_lens,
                                   scale=scale)
    _check(q, k_pages, v_pages, block_table, seq_lens)
    B, H, hd = q.shape
    _, page, K, _ = k_pages.shape
    max_pages = block_table.shape[1]
    scale = hd ** -0.5 if scale is None else scale
    n_split = split_count(max_pages, page)
    out = torch.empty_like(q)
    # per (sequence, query head, partition): max, sum, unnormalised output
    partials = (torch.empty(B * H * n_split * (hd + 2), dtype=torch.float32,
                            device=q.device) if n_split > 1 else None)
    KERNEL.launch(q.device, q.data_ptr(), k_pages.data_ptr(),
                  v_pages.data_ptr(), block_table.data_ptr(),
                  seq_lens.data_ptr(), out.data_ptr(),
                  None if partials is None else partials.data_ptr(),
                  DTYPE_CODES[q.dtype], B, H, K, hd, page, max_pages,
                  PARTITION, n_split, float(scale))
    return out


def _check(q, k_pages, v_pages, block_table, seq_lens) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on CPU or CUDA tensors, got "
                         f"{q.device}")
    tensors = (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
               ("block_table", block_table), ("seq_lens", seq_lens))
    if any(t.device != q.device for _, t in tensors):
        raise ValueError("all inputs must be on one device")
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"expected q (B,H,hd) and k/v pages (P,page,K,hd), "
                         f"got {tuple(q.shape)}, {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    B, H, hd = q.shape
    K = k_pages.shape[2]
    if k_pages.shape[3] != hd or H % K or H // K not in GROUPS:
        raise ValueError(f"q {tuple(q.shape)} and pages "
                         f"{tuple(k_pages.shape)} do not match, or H/K not "
                         f"in {GROUPS}")
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
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported (have {HEAD_DIMS})")
    for name, t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
