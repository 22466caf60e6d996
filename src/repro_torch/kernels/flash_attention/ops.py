"""Public wrapper of the prefill attention kernel.

Takes the model layout (q (B,S,H,hd), k/v (B,T,K,hd)), which is also the CUDA
kernel's layout, so nothing is transposed on the GPU.  Tensors on the CPU go
through the plain version (``ref.py``); tensors on a GPU launch
``csrc/flash_attention.cu`` or raise.  Chunked prefill passes a slot's whole
cache as k/v with a query offset and a count of visible keys, so the chunk
attends to the resident prefix without a slice or a copy.  Keys and values
may differ in width: MLA prefill and chunks pass queries and keys of hd +
rd and values of vd (deepseek-v2-lite: 192 and 128; minicpm3-4b: 96 and
64).

bf16 runs ``flash_fwd_wgmma_kernel``, built on Hopper's own path: a
producer warpgroup keeps Q and a ring of K / V tiles in flight by TMA, and
two consumer warpgroups of 64 query rows each take S = Q·Kᵀ and O += P·V as
``wgmma`` products (P rounded to bf16 in registers, V read as it lies).
Each call encodes six TMA tensor maps on the host (:func:`map_encode_us`
times them); the maps of k and v end at ``kv_len``, so the rows past it
arrive as zeros and are never read.  f32 runs ``flash_fwd_tf32x3_kernel``,
whose every product is three TF32 tensor-core products of split operands,
f32-accurate whatever ``torch.backends.cuda.matmul.allow_tf32`` says.
``ref.py::flash_attention_tiled_ref`` rounds as each does.
"""

from __future__ import annotations

import ctypes

import torch

import numpy as np

from .._build import DTYPE_CODES, CudaKernel, refuse_autograd, report_meta
from .ref import flash_attention_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
# (q/k width, v width); (80, 80) is h2o-danube-1.8b's, (256, 256) gemma3-4b's,
# (192, 128) and (96, 64) are MLA in MHA form (deepseek-v2-lite, minicpm3-4b)
HEAD_DIMS = ((64, 64), (128, 128), (192, 128), (96, 64), (80, 80), (256, 256))
# Keys a KV tile of the f32 kernel, by q/k width (csrc/flash_attention.cu,
# tf32x3::kKvTile): 16 above 128, so that two blocks fit an SM at 192 (one
# at 256).
F32_KV_TILE = {64: 32, 80: 32, 96: 32, 128: 32, 192: 16, 256: 16}
# Keys a KV tile of the bf16 kernel (wgmma_tc::kKvTile): 128, and 64 at 256,
# where the output accumulator alone takes 128 registers a thread.  P's
# rounding follows the tiles, so ``flash_attention_tiled_ref`` takes the
# kernel's tile.
BF16_KV_TILE = {64: 128, 80: 128, 96: 128, 128: 128, 192: 128, 256: 64}


class FlashKernel(CudaKernel):
    """The flash library, which also counts its launches with a query
    offset (``offset_launches``), so a serve can show that chunked prefill
    ran through the kernel, and those with a sliding window
    (``window_launches``), so a serve can show which layers ran windowed."""

    def __init__(self):
        super().__init__("flash_attention", "flash_attention_fwd",
                         [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _I, ctypes.c_float, _I, _I, _P])
        self.offset_launches = 0
        self.window_launches = 0


KERNEL = FlashKernel()


def map_encode_us(q, k, v, iters: int = 1000) -> float:
    """Host µs that encoding one bf16 call's six TMA tensor maps takes at
    these tensors' shapes (q (B,S,H,hd), k (B,T,K,hd), v (B,T,K,hd_v) on the
    card), the mean over ``iters`` encodes (``csrc/flash_attention.cu::
    flash_attention_map_encode_us``); the wrapper pays it on every call."""
    KERNEL.load()
    fn = KERNEL._lib.flash_attention_map_encode_us
    fn.argtypes = [_P, _P, _P] + [_I] * 8
    fn.restype = ctypes.c_double
    B, S, H, hd = q.shape
    us = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), B, S, k.shape[1], H,
            k.shape[2], hd, v.shape[3], iters)
    if us < 0:
        raise RuntimeError(f"no bf16 tensor maps for head dims ({hd}, "
                           f"{v.shape[3]})")
    return us


def visible_pairs(S: int, causal: bool, window: int, q_offset: int = 0,
                  kv_len: int | None = None) -> int:
    """(query, key) pairs a call attends over: query s at position
    ``q_offset + s`` sees the first ``kv_len`` keys (default S), up to its
    own position when causal, and the last ``window`` of them when
    windowed."""
    kv_len = S if kv_len is None else kv_len
    a = q_offset + np.arange(S, dtype=np.int64)
    lo = np.maximum(0, a - window + 1) if window else np.zeros_like(a)
    hi = np.minimum(a + 1, kv_len) if causal else np.full_like(a, kv_len)
    return int(np.maximum(hi - lo, 0).sum())


def flash_counts(B, S, H, K, hd, elem, causal, window, q_offset=0,
                 kv_len=None, hd_v=None) -> tuple:
    """(FLOPs, bytes) of one call: the matmul FLOPs over the visible pairs
    (:func:`visible_pairs`), and q and out, and the visible k and v, moved
    once (values of ``hd_v``, default hd)."""
    kv_len = S if kv_len is None else kv_len
    hd_v = hd if hd_v is None else hd_v
    pairs = visible_pairs(S, causal, window, q_offset, kv_len)
    flops = 2.0 * B * H * (hd + hd_v) * pairs
    nbytes = elem * (B * S * H * (hd + hd_v) + B * kv_len * K * (hd + hd_v))
    return flops, nbytes


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None, q_offset: int = 0,
                    kv_len: int | None = None, impl: str | None = None):
    """q (B,S,H,hd); k (B,T,K,hd), v (B,T,K,hd_v) → (B,S,H,hd_v), H a
    multiple of K; the scale defaults to hd^-0.5.

    Query row i stands at absolute position ``q_offset + i``; only the
    first ``kv_len`` keys (default T) are visible, and the rest of k and v
    is never read.  Causal and sliding-window masks use these absolute
    positions; a query row with no visible key gives 0.  ``impl=None``
    picks by device (CPU: plain version, CUDA: kernel); ``impl="plain"``
    forces the plain version.  Raises ``RuntimeError`` under autograd
    (``_build.refuse_autograd``): training attention does not come here."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    refuse_autograd("flash_attention", q, k, v)
    T = k.shape[1]
    kv_len = T if kv_len is None else int(kv_len)
    q_offset = int(q_offset)
    if not 0 <= kv_len <= T or q_offset < 0:
        raise ValueError(f"need 0 <= kv_len <= {T} and q_offset >= 0, got "
                         f"kv_len {kv_len}, q_offset {q_offset}")
    if impl == "plain" or q.device.type == "cpu":
        out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window, scale=scale,
                                  q_offset=q_offset, kv_len=kv_len)
        return out.transpose(1, 2)
    if q.device.type == "meta":
        return _meta(q, k, v, causal, window, q_offset, kv_len)
    _check(q, k, v, window)
    B, S, H, hd = q.shape
    K, hd_v = k.shape[2], v.shape[3]
    scale = hd ** -0.5 if scale is None else scale
    out = torch.empty((B, S, H, hd_v), dtype=q.dtype, device=q.device)
    KERNEL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), DTYPE_CODES[q.dtype], B, S, T, kv_len,
                  q_offset, H, K, hd, hd_v, float(scale), int(bool(causal)),
                  int(window))
    if q_offset > 0:
        KERNEL.offset_launches += 1
    if window > 0:
        KERNEL.window_launches += 1
    return out


def _meta(q, k, v, causal, window, q_offset, kv_len):
    """The output's shape and type on meta tensors, the kernel's work
    reported to the active counters."""
    B, S, H, hd = q.shape
    flops, nbytes = flash_counts(B, S, H, k.shape[2], hd, q.element_size(),
                                 causal, window, q_offset, kv_len, v.shape[3])
    report_meta("flash_attention", flops, nbytes)
    return q.new_empty((B, S, H, v.shape[3]))


def _check(q, k, v, window: int) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA tensors, got "
                         f"{q.device}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("q, k and v must be on one device")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"expected q (B,S,H,hd), k (B,T,K,hd) and v "
                         f"(B,T,K,hd_v), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not "
                         f"match (batch, head_dim, H % K)")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if (hd, v.shape[3]) not in HEAD_DIMS:
        raise ValueError(f"head dims ({hd}, {v.shape[3]}) not supported "
                         f"(have {HEAD_DIMS})")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
