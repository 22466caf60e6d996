"""Public wrappers of the SSD kernel.

``ssd_chunk`` is the intra-chunk part (the JAX ``ssd_chunk_call``): tensors
on the CPU go through the plain version (``ref.py``); tensors on a GPU launch
``csrc/ssd_scan.cu`` or raise.  ``ssd`` is the whole scan: it pads the
sequence to whole chunks with ``dt = 0`` (exact: the state passes through a
position with ``dt = 0`` unchanged), runs ``ssd_chunk``, then the
inter-chunk recurrence and the ``y_off`` term in PyTorch, as the JAX
wrapper leaves them to XLA (``repro/kernels/ssd_scan/ops.py:37-50``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .._build import DTYPE_CODES, CudaKernel
from .ref import ssd_chunk_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("ssd_scan", "ssd_chunk_fwd",
                    [_P] * 9 + [_I] * 8 + [_P])
HEAD_DIMS = (16, 32, 64, 128)
MAX_STATE = 256


def ssd_chunk(x, dt, A_log, B, C, *, impl: str | None = None):
    """Intra-chunk SSD over all (batch, chunk, head) cells.

    x (b,nc,Q,H,P); dt (b,nc,Q,H); A_log (H,), the kernel applies ``−exp``;
    B, C (b,nc,Q,G,N) with H a multiple of G (head h reads group
    ``h // (H/G)``).  Returns, all f32: y_diag (b,nc,Q,H,P), chunk-end
    states (b,nc,H,N,P), in-chunk decays (b,nc,Q,H), chunk decays
    (b,nc,H).  ``impl=None`` picks by device (CPU: plain version, CUDA:
    kernel); ``impl="plain"`` forces the plain version."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    if impl == "plain" or x.device.type == "cpu":
        return ssd_chunk_ref(x, dt, A_log, B, C)
    _check(x, dt, A_log, B, C)
    b, nc, Q, H, P = x.shape
    G, N = B.shape[3], B.shape[4]
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((b, nc, Q, H, P), **f32)
    states = torch.empty((b, nc, H, N, P), **f32)
    decay = torch.empty((b, nc, Q, H), **f32)
    chunk_decay = torch.empty((b, nc, H), **f32)
    KERNEL.launch(x.device, x.data_ptr(), dt.data_ptr(), A_log.data_ptr(),
                  B.data_ptr(), C.data_ptr(), y.data_ptr(), states.data_ptr(),
                  decay.data_ptr(), chunk_decay.data_ptr(),
                  DTYPE_CODES[x.dtype], b, nc, Q, H, G, P, N)
    return y, states, decay, chunk_decay


def _check(x, dt, A_log, B, C) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk runs on CPU or CUDA tensors, got "
                         f"{x.device}")
    tensors = (("x", x), ("dt", dt), ("A_log", A_log), ("B", B), ("C", C))
    if any(t.device != x.device for _, t in tensors):
        raise ValueError("all inputs must be on one device")
    if x.dim() != 5 or B.dim() != 5 or C.shape != B.shape:
        raise ValueError(f"expected x (b,nc,Q,H,P) and B/C (b,nc,Q,G,N), got "
                         f"{tuple(x.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    b, nc, Q, H, P = x.shape
    G, N = B.shape[3], B.shape[4]
    if (tuple(B.shape[:3]) != (b, nc, Q) or tuple(dt.shape) != (b, nc, Q, H)
            or tuple(A_log.shape) != (H,) or H % G):
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A_log {tuple(A_log.shape)}, B "
                         f"{tuple(B.shape)}")
    if x.dtype not in DTYPE_CODES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"x, B and C must all be float32 or bfloat16, got "
                         f"{x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A_log.dtype != torch.float32:
        raise ValueError("dt and A_log must be float32")
    if P not in HEAD_DIMS or N % 8 or not 0 < N <= MAX_STATE:
        raise ValueError(f"head_dim {P} not in {HEAD_DIMS}, or state {N} not "
                         f"a multiple of 8 up to {MAX_STATE}")
    for name, t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def ssd(x, dt, A_log, B, C, *, chunk: int = 256, h_init=None,
        impl: str | None = None):
    """Full SSD scan.  x (b,s,H,P); dt (b,s,H) (f32); A_log (H,); B, C
    (b,s,G,N); h_init (b,H,P,N) f32 or None (zeros).

    Chunks are ``min(chunk, s)`` positions; the sequence is padded at its
    end to whole chunks with ``dt = 0``.  Returns (y (b,s,H,P) in x's dtype,
    final state (b,H,P,N) f32), the state after position s-1 — the JAX
    ``ops.ssd`` returns y only."""
    b, s, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = min(chunk, s)
    pad = -s % Q
    nc = (s + pad) // Q

    def chunks(t, width):
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t
        return t.contiguous().view(b, nc, Q, *width)

    Cc = chunks(C, (G, N))
    y_diag, states, in_decay, chunk_decay = ssd_chunk(
        chunks(x, (H, P)), chunks(dt.float(), (H,)), A_log.float().contiguous(),
        chunks(B, (G, N)), Cc, impl=impl)

    # inter-chunk recurrence: the state entering each chunk, (P, N) order
    h = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if h_init is None else h_init.float())
    st = states.transpose(-1, -2)                        # (b,nc,H,P,N)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + st[:, c]
    h_prev = torch.stack(h_prev, dim=1).view(b, nc, G, H // G, P, N)

    # y_off = C · h_prev · exp(cum), per head of each group
    y_off = torch.einsum("bcqgn,bcgrpn->bcqgrp", Cc.float(), h_prev).reshape(
        b, nc, Q, H, P) * in_decay[..., None]
    y = (y_diag + y_off).view(b, nc * Q, H, P)[:, :s]
    return y.to(x.dtype), h
