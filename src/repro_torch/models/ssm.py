"""Mamba-2 (SSD — state-space duality) mixer block [arXiv:2405.21060].

Ported from the JAX package's ``models/ssm.py``.  Prefill runs the chunked
SSD through ``kernels.ssd_scan.ops.ssd`` (the CUDA kernel for the
intra-chunk part on a GPU); the training forward (``ssm_forward(...,
train=True)``) runs :func:`ssd_chunked`, the same scan in f32 torch ops
that autograd differentiates (the kernel wrappers refuse autograd); decode
is the one-step recurrence.

Layout as in the JAX package:
    x  (B, S, H, P)   — P = ssm_head_dim, H = d_inner / P heads
    dt (B, S, H)      — softplus-positive step sizes, f32
    A_log (H,)        — log decay rates (the decay is ``−exp(A_log)``)
    B, C (B, S, G, N) — input/output projections, G groups shared by heads
    decode cache: {"ssm": (B, H, P, N) f32, "conv": (B, W-1, conv_dim)}

Unlike the JAX prefill, ``ssm_forward`` takes per-row ``true_lens``: a
right-padded row gets ``dt = 0`` at its padding (the state passes through
unchanged, exactly) and its conv tail ends at ``true_len - 1``, so each
row's cache is that of the row alone.  Any prompt length works, in prefill
and in training: the scan pads to whole chunks the same way (the JAX
``ssd_chunked`` asserts that chunks divide S).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed.spmd import is_dtensor, replicated
from ..kernels.ssd_scan.ops import ssd
from ..kernels.ssd_scan.ref import ssd_scan
from .common import (causal_depthwise_conv, conv_decode_step, conv_tail,
                     dense_init, rms_norm)


def init_ssm(generator: torch.Generator, cfg: ModelConfig, dtype,
             device) -> dict:
    """Fresh mixer weights (the JAX initializer's distributions)."""
    d, di = cfg.d_model, cfg.d_inner
    H, N, G = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_groups
    conv_dim = di + 2 * G * N
    conv_w = torch.randn((cfg.conv_width, conv_dim), generator=generator,
                         dtype=torch.float32, device=device) * 0.2
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(generator, d, 2 * di + 2 * G * N + H, dtype,
                              device),
        "conv_w": conv_w.to(dtype),
        "A_log": torch.log(torch.from_numpy(
            np.linspace(1.0, 16.0, H, dtype=np.float32)).to(device)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "norm": torch.zeros((di,), dtype=dtype, device=device),
        "out_proj": dense_init(generator, di, d, dtype, device),
    }


def ssd_chunk_train(x, dt, A_log, B, C):
    """Intra-chunk SSD in f32 torch ops, the layout and outputs of
    ``kernels.ssd_scan.ref.ssd_chunk_ref``: x (b,nc,Q,H,P); dt
    (b,nc,Q,H); A_log (H,); B, C (b,nc,Q,G,N).  Returns y_diag
    (b,nc,Q,H,P), chunk-end states (b,nc,H,N,P), in-chunk decays
    ``exp(cum)`` (b,nc,Q,H) and chunk decays (b,nc,H).

    The JAX package's segment sums ``cum_i − cum_j`` subtract cumulative
    decays of order 10³ within a 256-position chunk (mamba2-370m's fastest
    head decays by ~16·dt a position), and their backward cancels the same
    large terms: in f32 that leaves ``A_log``'s gradient 7.9e-5 of its
    scale from the exact one (the recurrence in f64) at mamba2's decay
    rates, and an H100 and the CPU 1.6e-4 apart on mamba2-370m at 2 layers.
    Here each ``seg[i, j] = Σ_{j<t≤i} a_t`` is a cumulative sum of its own
    terms (a (Q, Q) cumsum), and the decay to the chunk's end is its last
    row: the same gradient is within 1.9e-7 of the exact one
    (``tests/test_torch_ssm.py::TestSSDChunked``).  The scores ``C·Bᵀ``
    are taken once a group, not once a head."""
    b, nc, Q, H, P = x.shape
    G, N = B.shape[3], B.shape[4]
    R = H // G
    dtf = dt.float().permute(0, 1, 3, 2)                         # (b,nc,H,Q)
    a = -torch.exp(A_log.float())[:, None] * dtf
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    seg = torch.cumsum(a[..., :, None].expand(b, nc, H, Q, Q).masked_fill(
        ~causal.tril(-1), 0.0), dim=-2)                          # (..,i,j)
    Bg = B.float().permute(0, 1, 3, 2, 4)                        # (b,nc,G,Q,N)
    Cg = C.float().permute(0, 1, 3, 2, 4)
    decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
    scores = ((Cg @ Bg.transpose(-1, -2))[:, :, :, None]
              * decay.view(b, nc, G, R, Q, Q)).view(b, nc, H, Q, Q)
    xd = x.float().permute(0, 1, 3, 2, 4) * dtf[..., None]       # (b,nc,H,Q,P)
    y = (scores @ xd).permute(0, 1, 3, 2, 4)                     # (b,nc,Q,H,P)
    Bh = Bg[:, :, :, None].expand(b, nc, G, R, Q, N).reshape(b, nc, H, Q, N)
    decay_end = torch.exp(seg[..., -1, :])                       # (b,nc,H,Q)
    states = (Bh * decay_end[..., None]).transpose(-1, -2) @ xd  # (..,N,P)
    cum = torch.cumsum(a, dim=-1)
    return (y.contiguous(), states,
            torch.exp(cum).permute(0, 1, 3, 2).contiguous(),
            torch.exp(cum[..., -1]))


def ssd_chunked(x, dt, A_log, B, C, chunk: int, h_init=None):
    """Chunked SSD scan in f32 torch ops, differentiable: the counterpart
    of the JAX package's ``ssd_chunked`` (``x·dt``, B and C in f32, the
    masked ``exp(segsum)``, ``y_diag``, chunk states, the inter-chunk
    recurrence and ``y_off``), the segment sums taken as
    :func:`ssd_chunk_train` takes them, with ``kernels.ssd_scan.ops.ssd``'s
    padding to whole chunks with ``dt = 0``, so any S works.  x (b,s,H,P);
    dt (b,s,H); A_log (H,) (the decay is ``−exp(A_log)``); B, C (b,s,G,N);
    h_init (b,H,P,N) or None.  Returns (y (b,s,H,P) in x's dtype, final
    state (b,H,P,N) f32).  Calls no kernel wrapper."""
    return ssd_scan(x, dt, A_log, B, C, chunk=chunk, h_init=h_init,
                    chunk_fn=ssd_chunk_train)


def _split(xz, cfg: ModelConfig):
    """(z, xBC before the conv, dt_raw) of the input projection."""
    di, G, N = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    return (xz[..., :di], xz[..., di: 2 * di + 2 * G * N],
            xz[..., 2 * di + 2 * G * N:])


def _prefill_scan(xs, dt, A_log, Bm, Cm, chunk: int, impl):
    """``ops.ssd``; on DTensors through ``local_map``, each rank's kernel
    over its own batch rows and, where the heads divide over "model", its
    own heads (with their groups: all of them when G = 1)."""
    if not is_dtensor(xs):
        return ssd(xs, dt, A_log, Bm, Cm, chunk=chunk, impl=impl)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xs.device_mesh
    H, G = xs.shape[2], Bm.shape[2]
    px, pd, pa, pg, py, ph = [], [], [], [], [], []
    for i, p in enumerate(xs.placements):
        n = mesh.size(i)
        heads = (mesh.mesh_dim_names[i] == "model" and H % n == 0
                 and (G == 1 or G % n == 0))
        if isinstance(p, Shard) and p.dim == 0:
            row = [Shard(0)] * 5 + [Shard(0)]
            row[2] = Replicate()                       # A_log
        elif heads:
            row = [Shard(2), Shard(2), Shard(0),
                   Replicate() if G == 1 else Shard(2), Shard(2), Shard(1)]
        else:
            row = [Replicate()] * 6
        for lst, q in zip((px, pd, pa, pg, py, ph), row):
            lst.append(q)
    fn = local_map(lambda a, b, c, d, e: ssd(a, b, c, d, e, chunk=chunk,
                                             impl=impl),
                   out_placements=(py, ph),
                   in_placements=(px, pd, pa, pg, pg), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(xs, dt, replicated(A_log, mesh), Bm, Cm)


def ssm_forward(params, x, cfg: ModelConfig, *, true_lens=None,
                return_state: bool = False, impl: str | None = None,
                train: bool = False):
    """Full-sequence mixer.  x (B, S, d); ``true_lens`` (B,) the real
    length of each right-padded row, or None for all S.  Returns y (B, S,
    d), and with ``return_state`` also the decode cache after each row's
    last real position.  Prefill scans through ``ops.ssd`` (the kernel on
    a GPU); with ``train`` the scan is :func:`ssd_chunked`, which autograd
    differentiates."""
    B_, S, _ = x.shape
    di, H, P = cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state
    xz = x @ params["in_proj"]
    z, xBC_pre, dt_raw = _split(xz, cfg)
    xBC = F.silu(causal_depthwise_conv(xBC_pre, params["conv_w"]))
    xs = xBC[..., :di].reshape(B_, S, H, P)
    Bm = xBC[..., di:di + G * N].reshape(B_, S, G, N)
    Cm = xBC[..., di + G * N:].reshape(B_, S, G, N)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])          # (B,S,H)
    if true_lens is not None:
        real = (torch.arange(S, device=x.device)[None]
                < true_lens.to(x.device).long()[:, None])
        dt = dt * real[..., None]
    if train:
        y, h_final = ssd_chunked(xs, dt, params["A_log"], Bm, Cm,
                                 cfg.ssm_chunk)
    else:
        y, h_final = _prefill_scan(xs, dt, params["A_log"], Bm, Cm,
                                   cfg.ssm_chunk, impl)
    y = y + xs * params["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(B_, S, di) * F.silu(z)
    y = rms_norm(y, params["norm"], cfg.norm_eps)
    out = y @ params["out_proj"]
    if return_state:
        return out, {"ssm": h_final,
                     "conv": conv_tail(xBC_pre, cfg.conv_width, true_lens)}
    return out


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """Zero decode cache of one SSM layer."""
    di, H, P = cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state
    return {
        "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, di + 2 * G * N),
                            dtype=dtype, device=device),
    }


def ssm_decode(params, x, cache: dict, cfg: ModelConfig):
    """One decode step.  x (B, 1, d).  ``cache`` is updated **in place**.
    Returns (y (B, 1, d), cache)."""
    B_ = x.shape[0]
    di, H, P = cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state
    xz = x[:, 0, :] @ params["in_proj"]                          # (B, ...)
    z, xBC_pre, dt_raw = _split(xz, cfg)
    xBC, conv_state = conv_decode_step(xBC_pre, cache["conv"].to(xz.dtype),
                                       params["conv_w"])
    xBC = F.silu(xBC)
    xs = xBC[..., :di].reshape(B_, H, P)
    rep = H // G
    Bh = xBC[..., di:di + G * N].reshape(B_, G, N).repeat_interleave(
        rep, dim=1).float()
    Ch = xBC[..., di + G * N:].reshape(B_, G, N).repeat_interleave(
        rep, dim=1).float()
    dt = F.softplus(dt_raw.float() + params["dt_bias"])          # (B,H)
    a = torch.exp(-torch.exp(params["A_log"])[None, :] * dt)     # (B,H)
    xa = xs.float() * dt[..., None]
    h = cache["ssm"] * a[:, :, None, None] + xa[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhn,bhpn->bhp", Ch, h)
    y = y.to(x.dtype) + xs * params["D"][None, :, None].to(x.dtype)
    y = y.reshape(B_, di) * F.silu(z)
    y = rms_norm(y, params["norm"], cfg.norm_eps)
    cache["ssm"].copy_(h)
    cache["conv"].copy_(conv_state)
    return (y @ params["out_proj"])[:, None, :], cache
