"""Mamba-2 (SSD — state-space duality) mixer block [arXiv:2405.21060].

Ported from the JAX package's ``models/ssm.py`` (forward only).  Prefill
runs the chunked SSD through ``kernels.ssd_scan.ops.ssd`` (the CUDA kernel
for the intra-chunk part on a GPU); decode is the one-step recurrence.

Layout as in the JAX package:
    x  (B, S, H, P)   — P = ssm_head_dim, H = d_inner / P heads
    dt (B, S, H)      — softplus-positive step sizes, f32
    A_log (H,)        — log decay rates (the decay is ``−exp(A_log)``)
    B, C (B, S, G, N) — input/output projections, G groups shared by heads
    decode cache: {"ssm": (B, H, P, N) f32, "conv": (B, W-1, conv_dim)}

Unlike the JAX prefill, ``ssm_forward`` takes per-row ``true_lens``: a
right-padded row gets ``dt = 0`` at its padding (the state passes through
unchanged, exactly) and its conv tail ends at ``true_len - 1``, so each
row's cache is that of the row alone.  Any prompt length works: the scan
pads to whole chunks the same way.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.ssd_scan.ops import ssd
from .common import causal_depthwise_conv, conv_decode_step, dense_init, rms_norm


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


def _split(xz, cfg: ModelConfig):
    """(z, xBC before the conv, dt_raw) of the input projection."""
    di, G, N = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    return (xz[..., :di], xz[..., di: 2 * di + 2 * G * N],
            xz[..., 2 * di + 2 * G * N:])


def ssm_forward(params, x, cfg: ModelConfig, *, true_lens=None,
                return_state: bool = False, impl: str | None = None):
    """Full-sequence mixer (prefill).  x (B, S, d); ``true_lens`` (B,) the
    real length of each right-padded row, or None for all S.  Returns y
    (B, S, d), and with ``return_state`` also the decode cache after each
    row's last real position."""
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
    y, h_final = ssd(xs, dt, params["A_log"], Bm, Cm, chunk=cfg.ssm_chunk,
                     impl=impl)
    y = y + xs * params["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(B_, S, di) * F.silu(z)
    y = rms_norm(y, params["norm"], cfg.norm_eps)
    out = y @ params["out_proj"]
    if return_state:
        return out, {"ssm": h_final,
                     "conv": _conv_tail(xBC_pre, cfg, true_lens)}
    return out


def _conv_tail(xBC_pre, cfg: ModelConfig, true_lens=None):
    """The last W-1 pre-conv inputs of each row, ending at ``true_len - 1``
    and zero-filled in front when the row is shorter (the decode conv state
    after prefill)."""
    B_, S, _ = xBC_pre.shape
    W = cfg.conv_width
    ends = (torch.full((B_,), S, device=xBC_pre.device) if true_lens is None
            else true_lens.to(xBC_pre.device).long())
    pos = ends[:, None] - (W - 1) + torch.arange(W - 1,
                                                 device=xBC_pre.device)
    tail = xBC_pre[torch.arange(B_, device=xBC_pre.device)[:, None],
                   pos.clamp_min(0)]                              # (B,W-1,D)
    return tail * (pos >= 0)[..., None].to(tail.dtype)


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
