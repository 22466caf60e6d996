"""Plain PyTorch versions of the SSD kernel.

``ssd_chunk_ref`` is the body of the JAX Pallas kernel
(``repro/kernels/ssd_scan/kernel.py::_ssd_chunk_kernel``) over every
(batch·head, chunk) cell at once, in f32; ``ssd_chunk_tiled_ref`` spells
out the tensor-core kernels' arithmetic (key tiles; in bf16 the decayed
scores and the decayed inputs rounded to bf16 before their products, in
f32 every product taken as three TF32 products of split operands);
``ssd_ref`` is the sequential state-space recurrence, the oracle of
``repro/kernels/ssd_scan/ref.py``; ``ssd_scan`` is the whole chunked scan
around an intra-chunk function (the kernel wrapper, or a plain version in
torch ops, which autograd differentiates).  All take B and C by group (G
groups, H a multiple of G; head h reads group ``h // (H / G)``), which is
the JAX functions' head-broadcast layout when G = H.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..flash_attention.ref import einsum_tf32

LOG2E = math.log2(math.e)


def _heads(t: torch.Tensor, H: int, axis: int) -> torch.Tensor:
    """Broadcast the group axis of ``t`` to H heads, in f32."""
    return t.float().repeat_interleave(H // t.shape[axis], dim=axis)


def ssd_chunk_ref(x, dt, A_log, B, C):
    """Intra-chunk SSD over all cells.

    x (b,nc,Q,H,P); dt (b,nc,Q,H); A_log (H,) (the kernel applies
    ``−exp``); B, C (b,nc,Q,G,N).  Returns, all f32, y_diag (b,nc,Q,H,P),
    chunk-end states (b,nc,H,N,P), in-chunk decays ``exp(cum)`` (b,nc,Q,H)
    and chunk decays ``exp(cum_last)`` (b,nc,H)."""
    H = x.shape[3]
    Q = x.shape[2]
    Bh = _heads(B, H, 3).permute(0, 1, 3, 2, 4)        # (b,nc,H,Q,N)
    Ch = _heads(C, H, 3).permute(0, 1, 3, 2, 4)
    dtf = dt.float().permute(0, 1, 3, 2)               # (b,nc,H,Q)
    cum = torch.cumsum(-torch.exp(A_log.float())[:, None] * dtf, dim=-1)
    xd = x.float().permute(0, 1, 3, 2, 4) * dtf[..., None]   # (b,nc,H,Q,P)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(~causal,
                                                              float("-inf"))
    scores = (Ch @ Bh.transpose(-1, -2)) * torch.exp(seg)   # (b,nc,H,Q,Q)
    y = (scores @ xd).permute(0, 1, 3, 2, 4)                # (b,nc,Q,H,P)
    decay_end = torch.exp(cum[..., -1:] - cum)              # (b,nc,H,Q)
    states = (Bh * decay_end[..., None]).transpose(-1, -2) @ xd  # (b,nc,H,N,P)
    in_decay = torch.exp(cum).permute(0, 1, 3, 2)           # (b,nc,Q,H)
    chunk_decay = torch.exp(cum[..., -1])                   # (b,nc,H)
    return y.contiguous(), states, in_decay.contiguous(), chunk_decay


def ssd_chunk_tiled_ref(x, dt, A_log, B, C, *, tile: int = 64,
                        round: bool = True, tf32_products: int = 0):
    """Same layout and outputs as :func:`ssd_chunk_ref`, computed as the
    tensor-core kernels do.  Per cell and head, with ``c2 = cumsum(a) ·
    log2(e)``: the scores of a (query tile, key tile) pair on or below the
    diagonal are ``P′ = (C Bᵀ) · exp2(c2[i] − c2[j]) · dt[j]`` on ``j <=
    i``, and ``y += P′ · x``; the chunk-end state sums ``Bᵀ · (w ∘ x)`` over
    the key tiles, ``w[q] = dt[q] · exp(cum[Q−1] − cum[q])``.

    The bf16 kernels (``round``): P′ and ``w ∘ x`` rounded to bf16 before
    their products, every sum f32.  The f32 kernels (``tf32_products=3``,
    ``round=False``): C·Bᵀ, P′·x and Bᵀ·(w∘x) each as three TF32 products of
    split operands (``einsum_tf32``; ``tf32_products=1``: the single TF32
    product no kernel runs), and the decays as the kernels' f64 scan gives
    them: cum summed in f64, ``exp2(c2[i] − c2[j])``, ``exp(cum[Q−1] −
    cum)`` and ``exp(cum)`` taken in f64 and rounded once to f32.
    ``round=False`` alone gives :func:`ssd_chunk_ref`'s values up to f32
    summation order."""
    if tf32_products not in (0, 1, 3):
        raise ValueError(f"tf32_products must be 0, 1 or 3, got "
                         f"{tf32_products}")
    if tf32_products and round:
        raise ValueError("operands are rounded to bf16 or split into TF32, "
                         "not both")
    H, Q = x.shape[3], x.shape[2]
    rnd = ((lambda t: t.to(torch.bfloat16).float()) if round
           else (lambda t: t))
    Bh = _heads(B, H, 3).permute(0, 1, 3, 2, 4)        # (b,nc,H,Q,N)
    Ch = _heads(C, H, 3).permute(0, 1, 3, 2, 4)
    xh = x.float().permute(0, 1, 3, 2, 4)               # (b,nc,H,Q,P)
    dtf = dt.float().permute(0, 1, 3, 2)               # (b,nc,H,Q)
    a = -torch.exp(A_log.float())[:, None] * (dtf.double() if tf32_products
                                              else dtf)
    cum = torch.cumsum(a, dim=-1)                       # f64 for tf32
    c2 = cum * LOG2E
    y = torch.zeros_like(xh)
    for q0 in range(0, Q, tile):
        qs = slice(q0, min(q0 + tile, Q))
        i = torch.arange(qs.start, qs.stop, device=x.device)[:, None]
        for k0 in range(0, q0 + 1, tile):
            ks = slice(k0, min(k0 + tile, Q))
            j = torch.arange(ks.start, ks.stop, device=x.device)[None, :]
            s = einsum_tf32("...in,...jn->...ij", Ch[..., qs, :],
                            Bh[..., ks, :], tf32_products)
            decay = torch.exp2(c2[..., qs, None] - c2[..., None, ks]).float()
            p = torch.where(j <= i, s * decay * dtf[..., None, ks], 0.0)
            y[..., qs, :] += einsum_tf32("...ij,...jp->...ip", rnd(p),
                                         xh[..., ks, :], tf32_products)
    w = dtf * torch.exp(cum[..., -1:] - cum).float()    # (b,nc,H,Q)
    states = torch.zeros(xh.shape[:3] + (B.shape[-1], x.shape[-1]),
                         dtype=torch.float32, device=x.device)
    for k0 in range(0, Q, tile):
        ks = slice(k0, min(k0 + tile, Q))
        states += einsum_tf32("...jn,...jp->...np", Bh[..., ks, :],
                              rnd(w[..., ks, None] * xh[..., ks, :]),
                              tf32_products)
    in_decay = torch.exp(cum).float().permute(0, 1, 3, 2)   # (b,nc,Q,H)
    chunk_decay = torch.exp(cum[..., -1]).float()           # (b,nc,H)
    return (y.permute(0, 1, 3, 2, 4).contiguous(), states,
            in_decay.contiguous(), chunk_decay)


def ssd_ref(x, dt, A_log, B, C, h_init=None):
    """The exact recurrence, one step at a time.  x (b,s,H,P); dt (b,s,H);
    A_log (H,); B, C (b,s,G,N); h_init (b,H,P,N) or None.  Returns
    (y (b,s,H,P) f32, final state (b,H,P,N) f32)."""
    b, s, H, P = x.shape
    N = B.shape[-1]
    Bh, Ch = _heads(B, H, 2), _heads(C, H, 2)               # (b,s,H,N)
    dtf = dt.float()
    a = torch.exp(-torch.exp(A_log.float()) * dtf)          # (b,s,H)
    xd = x.float() * dtf[..., None]
    h = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if h_init is None else h_init.float().clone())
    ys = []
    for t in range(s):
        h = h * a[:, t, :, None, None] + xd[:, t, :, :, None] * Bh[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], h))
    return torch.stack(ys, dim=1), h


def ssd_scan(x, dt, A_log, B, C, *, chunk: int, h_init=None,
             chunk_fn=ssd_chunk_ref):
    """Full chunked SSD scan.  x (b,s,H,P); dt (b,s,H); A_log (H,); B, C
    (b,s,G,N); h_init (b,H,P,N) or None (zeros).  Chunks are ``min(chunk,
    s)`` positions, the sequence padded at its end to whole chunks with
    ``dt = 0``; ``chunk_fn`` computes the intra-chunk part (the layout and
    outputs of :func:`ssd_chunk_ref`), then the inter-chunk recurrence and
    ``y_off`` run here in torch ops.  Returns (y (b,s,H,P) in x's dtype,
    final state (b,H,P,N) f32)."""
    b, s, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = min(chunk, s)
    pad = -s % Q
    nc = (s + pad) // Q

    def chunks(t, width):
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t
        return t.contiguous().view(b, nc, Q, *width)

    Cc = chunks(C, (G, N))
    y_diag, states, in_decay, chunk_decay = chunk_fn(
        chunks(x, (H, P)), chunks(dt.float(), (H,)), A_log.float().contiguous(),
        chunks(B, (G, N)), Cc)

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
