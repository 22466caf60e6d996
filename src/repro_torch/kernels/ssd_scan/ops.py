"""Public wrappers of the SSD kernel.

``ssd_chunk`` is the intra-chunk part (the JAX ``ssd_chunk_call``): tensors
on the CPU go through the plain version (``ref.py``); tensors on a GPU launch
``csrc/ssd_scan.cu`` or raise.  ``ssd`` is the whole scan (``ref.py::ssd_scan``
over ``ssd_chunk``): it pads the sequence to whole chunks with ``dt = 0``
(exact: the state passes through a position with ``dt = 0`` unchanged),
runs ``ssd_chunk``, then the inter-chunk recurrence and the ``y_off`` term
in PyTorch, as the JAX wrapper leaves them to XLA
(``repro/kernels/ssd_scan/ops.py:37-50``).
"""

from __future__ import annotations

import ctypes
from functools import partial

import torch

from .._build import DTYPE_CODES, CudaKernel, refuse_autograd, report_meta
from .ref import ssd_chunk_ref, ssd_scan

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("ssd_scan", "ssd_chunk_fwd",
                    [_P] * 9 + [_I] * 8 + [_P])
HEAD_DIMS = (16, 32, 64, 128)
MAX_STATE = 256
# Longest chunk the kernels take: a block keeps dt and the decays over the
# whole chunk in shared memory (csrc/ssd_scan.cu states the sizes).
MAX_CHUNK = 8192


def ssd_counts(b, S, H, P, G, N, Q, elem) -> tuple:
    """(FLOPs, bytes) of one ``ssd_chunk`` call over S positions in chunks
    of Q: x, B and C (read by group) in the input type, dt f32 and A_log
    read once; y, states and decays written once in f32; FLOPs of the
    causal half of C·Bᵀ once a group, and of (C·Bᵀ∘L)·(x·dt) plus the
    chunk-end state once a head, per chunk."""
    nc = S // Q
    nbytes = (elem * (b * S * H * P + 2 * b * S * G * N) + 4 * (b * S * H + H)
              + 4 * (b * S * H * P + b * nc * H * N * P + b * S * H
                     + b * nc * H))
    pairs = Q * (Q + 1) // 2
    flops = b * nc * (G * 2.0 * pairs * N
                      + H * (2.0 * pairs * P + 2.0 * Q * N * P))
    return flops, nbytes


def ssd_chunk(x, dt, A_log, B, C, *, impl: str | None = None):
    """Intra-chunk SSD over all (batch, chunk, head) cells.

    x (b,nc,Q,H,P); dt (b,nc,Q,H); A_log (H,), the kernel applies ``−exp``;
    B, C (b,nc,Q,G,N) with H a multiple of G (head h reads group
    ``h // (H/G)``).  Returns, all f32: y_diag (b,nc,Q,H,P), chunk-end
    states (b,nc,H,N,P), in-chunk decays (b,nc,Q,H), chunk decays
    (b,nc,H).  ``impl=None`` picks by device (CPU: plain version, CUDA:
    kernel); ``impl="plain"`` forces the plain version.  Raises
    ``RuntimeError`` under autograd (``_build.refuse_autograd``)."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    refuse_autograd("ssd_chunk", x, dt, A_log, B, C)
    if impl == "plain" or x.device.type == "cpu":
        return ssd_chunk_ref(x, dt, A_log, B, C)
    if x.device.type == "meta":
        return _meta(x, B)
    _check(x, dt, A_log, B, C)
    b, nc, Q, H, P = x.shape
    G, N = B.shape[3], B.shape[4]
    y, states, decay, chunk_decay = _outputs(x, B)
    KERNEL.launch(x.device, x.data_ptr(), dt.data_ptr(), A_log.data_ptr(),
                  B.data_ptr(), C.data_ptr(), y.data_ptr(), states.data_ptr(),
                  decay.data_ptr(), chunk_decay.data_ptr(),
                  DTYPE_CODES[x.dtype], b, nc, Q, H, G, P, N)
    return y, states, decay, chunk_decay


def _outputs(x, B) -> tuple:
    """Empty f32 y_diag, chunk-end states, in-chunk and chunk decays."""
    b, nc, Q, H, P = x.shape
    N = B.shape[4]
    f32 = dict(dtype=torch.float32, device=x.device)
    return (torch.empty((b, nc, Q, H, P), **f32),
            torch.empty((b, nc, H, N, P), **f32),
            torch.empty((b, nc, Q, H), **f32), torch.empty((b, nc, H), **f32))


def _meta(x, B) -> tuple:
    """The outputs' shapes on meta tensors, the kernel's work reported to
    the active counters."""
    b, nc, Q, H, P = x.shape
    G, N = B.shape[3], B.shape[4]
    report_meta("ssd_chunk", *ssd_counts(b, nc * Q, H, P, G, N, Q,
                                         x.element_size()))
    return _outputs(x, B)


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
    if Q > MAX_CHUNK:
        raise ValueError(f"chunk length {Q} is over {MAX_CHUNK}, the longest "
                         f"the kernels keep in shared memory")
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
    ``ops.ssd`` returns y only.  Raises ``RuntimeError`` under autograd,
    as :func:`ssd_chunk` does (the training forward runs
    ``models/ssm.py::ssd_chunked``, the same scan over ``ssd_chunk_ref``)."""
    refuse_autograd("ssd", x, dt, A_log, B, C, h_init)
    return ssd_scan(x, dt, A_log, B, C, chunk=chunk, h_init=h_init,
                    chunk_fn=partial(ssd_chunk, impl=impl))
