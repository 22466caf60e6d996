"""Public wrapper of the prefill attention kernel.

Takes the model layout (q (B,S,H,hd), k/v (B,T,K,hd)), which is also the CUDA
kernel's layout, so nothing is transposed on the GPU.  Tensors on the CPU go
through the plain version (``ref.py``); tensors on a GPU launch
``csrc/flash_attention.cu`` or raise.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import DTYPE_CODES, CudaKernel
from .ref import flash_attention_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("flash_attention", "flash_attention_fwd",
                    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     ctypes.c_float, _I, _I, _P])
HEAD_DIMS = (64, 128)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None, impl: str | None = None):
    """q (B,S,H,hd); k/v (B,T,K,hd) → (B,S,H,hd), H a multiple of K.

    Causal and sliding-window masks use absolute positions 0..S-1 and
    0..T-1; a query row with no visible key gives 0.  ``impl=None`` picks by
    device (CPU: plain version, CUDA: kernel); ``impl="plain"`` forces the
    plain version."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    if impl == "plain" or q.device.type == "cpu":
        out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window, scale=scale)
        return out.transpose(1, 2)
    _check(q, k, v, window)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    KERNEL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), DTYPE_CODES[q.dtype], B, S, T, H, K, hd,
                  float(scale), int(bool(causal)), int(window))
    return out


def _check(q, k, v, window: int) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA tensors, got "
                         f"{q.device}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("q, k and v must be on one device")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,S,H,hd) and k/v (B,T,K,hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not "
                         f"match (batch, head_dim, H % K)")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported (have {HEAD_DIMS})")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
