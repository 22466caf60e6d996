#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. setup: print the card's name and power limit, build the three CUDA
   kernels from ``src/repro_torch/csrc`` (one ``nvcc`` each, in parallel);
2. kernels: hold flash attention (bf16 on the tensor cores, f32 on the
   CUDA cores), paged attention (split sequences, then merge) and the SSD
   chunk kernel against their plain PyTorch versions on the card at the
   main paths' shapes (the llama2 prefill buckets from B=8 S=128 to B=2
   S=2048; 8 decode slots of 2048 tokens, one long among short ones
   included) and, for flash, the chunked-prefill shapes (queries at an
   offset into a 2048-position slot cache whose rows past the visible keys
   hold NaN, which must never be read); bf16 flash is also held element by
   element against
   ``flash_attention_tiled_ref``, and the bf16 SSD main case against
   ``ssd_chunk_tiled_ref``, each of which rounds what its kernel rounds.
   Times kernel (graph and eager timers), plain version, the least time the
   card could take (bound) and, for attention,
   ``torch.nn.functional.scaled_dot_product_attention`` (a yardstick only:
   the port never calls it; no single PyTorch call computes SSD);
3. parity: llama2-13b and mamba2-370m at full width and 2 layers, in f32 —
   one prefill and a few greedy decode steps through the kernels and
   through the plain versions must give the same tokens and close logits,
   and llama2's prompt fed through ``chunk_step`` in chunks of 512, 512 and
   the rest must give the prefill's tokens and logits;
4. serve: ``repro_torch.serving.api.serve`` runs llama2-13b at full width
   and depth (random bf16 weights from a seed) under EWSJF over a mixed
   short/long workload, then the same weights in chunked-prefill +
   radix-reuse mode over shared-prefix traffic, then mamba2-370m; every
   request must finish, each path's kernels must have launched in its own
   run, the prefix run must attach the cached prefix for at least 16
   requests and leave only radix tenancy in the pool.  Between the prefix
   run and mamba2, with the same llama2 weights:
   - replay: ``serving.replay.run_replay`` feeds one 24-request burst
     through the DES (H100 roofline) and the bucketed engine under FCFS,
     SJF and EWSJF; FCFS and SJF must dispatch as the DES does, EWSJF
     within the rank-correlation bound, and greedy tokens that differ
     between runs must part at a near-tie within the measured bf16 noise
     of the prefill batch's shape;
   - fleet: two chunked+radix engines sharing the weights behind
     ``cluster.EngineFleet`` serve shared-prefix traffic; the router must
     plan a remote prefix fetch that ships real host KV bytes, which the
     fetched request attaches;
5. summary: one call of each kernel's bf16 main case under
   ``torch.profiler`` names the device kernels that ran (the ``variant``
   of its entry); a line of the replaced designs' times as recorded in
   PERF.md (not measured here), each beside this run's time by the same
   timer; one JSON line of per-kernel numbers
   measured in this run; then the last line ``{"ok": true, "device":
   {...}}``.

TF32 is switched off for matmuls and cuDNN below, so every f32 product in
the plain versions and in the model is full f32.

It exits non-zero, printing no result, when no GPU is visible or when the
repository's ``src/repro_torch`` is not beside it.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BF16_PEAK_FLOPS = 989e12     # H100 SXM data sheet, dense bf16 tensor cores
F32_PEAK_FLOPS = 67e12       # H100 SXM data sheet, f32 outside tensor cores
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
F32_TOL, BF16_TOL = 1e-4, 3e-2   # kernel vs plain: summation order differs
# bf16 flash vs its tiled plain version, per element: |d| <= atol + rtol·|ref|.
# Both round the same P and the same output to bf16 (an ulp is at most 2^-7
# of the value); what is left is f32 summation order.
TILED_ATOL, TILED_RTOL = 1e-3, 1e-2
# bf16 SSD vs ssd_chunk_tiled_ref, per element: |d| <= atol · max|ref| +
# rtol·|ref|.  Both round the same P′ and w∘x to bf16; what is left is f32
# summation order, exp2 and the decay scan's order, which can also move a
# rounded operand by one bf16 ulp (2^-8 of it).
SSD_TILED_ATOL, SSD_TILED_RTOL = 1e-3, 1e-2
# The llama2 serve's decode shape at its worst: one long slot among short ones.
LONG_AMONG_SHORT = [2000, 17, 99, 1, 64, 33, 80, 5]
# Main-case times of the designs the three kernels replaced, as PERF.md
# section 6 records them, by the timer each was taken with (NVIDIA H100 80GB
# HBM3 at 700 W): the attention kernels' by the eager timer of the
# chip_smoke.py that added the SSD kernel; the CUDA-core bf16 SSD kernel's
# 0.9817 ms by that eager timer and 0.9765 ms by the graph timer of the
# chip_smoke.py that redesigned attention.  Printed on a line of their own,
# labelled as recorded, each beside this run's time by the same timer,
# never in the kernels line.
RECORDED_EARLIER_MS = {"flash_attention": {"eager": 1.0194},
                       "paged_attention": {"eager": 0.3273},
                       "ssd_chunk": {"eager": 0.9817, "graph": 0.9765}}


def check(cond: bool, what: str) -> None:
    """Raise when a phase's condition fails."""
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, iters: int = 20, warmup: int = 3, graph: bool = True) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events.
    With ``graph`` the events bracket one replay of a CUDA graph that holds
    the ``iters`` calls, so the host's time to issue a call (the wrapper's
    checks, the launch) does not count even where it exceeds a small
    kernel's; without it they bracket ``iters`` eager calls (the timer of
    the runs before the graph timer)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if not graph:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    cuda_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(cuda_graph):
        for _ in range(iters):
            fn()
    cuda_graph.replay()
    torch.cuda.synchronize()
    start.record()
    cuda_graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def launched_kernels(fn) -> list:
    """The device kernels one call of ``fn`` ran, as ``torch.profiler``
    names them (namespace, return type and arguments dropped)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = set()
    for ev in prof.key_averages():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and ev.self_device_time_total > 0):
            name = ev.key.replace("(anonymous namespace)::", "")
            names.add(name.removeprefix("void ").split("(")[0])
    return sorted(names)


def max_err(a, b) -> float:
    """Largest absolute difference, in f32."""
    return float((a.float() - b.float()).abs().max())


def phase_setup(kbuild) -> None:
    """Card name and power limit; build both kernels in parallel."""
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.monotonic()
    logs = kbuild.build()
    print(f"[setup] kernels built in {time.monotonic() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "built in" in line:
                print(f"[setup]   {name}: {line.strip()}")


def flash_case(fa, B, S, H, K, hd, dtype, causal, window, seed, q_offset=0,
               T=None, kv_len=None):
    """One flash-attention comparison: S queries at ``q_offset`` against the
    first ``kv_len`` keys (default all) of (B, T, K, hd) keys and values (T
    defaults to S); rows past ``kv_len`` hold NaN, which must never be read.
    Returns (max_abs_err, worst |d| / (atol + rtol·|ref|) against the tiled
    plain version (bf16; None for f32), kernel_ms, eager kernel_ms,
    plain_ms, library_ms, the kernel call)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_tiled_ref)
    T = S if T is None else T
    kv_len = T if kv_len is None else kv_len
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q = torch.randn((B, S, H, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, T, K, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, T, K, hd), generator=g, device="cuda").to(dtype)
    k[:, kv_len:] = float("nan")
    v[:, kv_len:] = float("nan")
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    what = (f"flash {dtype} B{B} S{S} H{H} K{K} w{window} q_offset{q_offset} "
            f"kv_len{kv_len}")
    out = fa.flash_attention(q, k, v, **kw)
    ref = fa.flash_attention(q, k, v, impl="plain", **kw)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    check(bool(torch.isfinite(out.float()).all()), f"{what} output finite")
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    check(err <= tol, f"{what} err {err:.3g} <= {tol}")
    tiled = None
    if dtype == torch.bfloat16:
        ref_t = flash_attention_tiled_ref(
            *(t.transpose(1, 2) for t in (q, k, v)), **kw).transpose(1, 2).float()
        tiled = float(((out.float() - ref_t).abs()
                       / (TILED_ATOL + TILED_RTOL * ref_t.abs())).max())
        check(tiled <= 1.0, f"{what} within {TILED_ATOL} + {TILED_RTOL}·|ref| "
                            f"of the tiled plain version (worst {tiled:.3g})")

    def call():
        return fa.flash_attention(q, k, v, **kw)
    kms = time_ms(call)
    ems = time_ms(call, graph=False)
    pms = time_ms(lambda: fa.flash_attention(q, k, v, impl="plain", **kw),
                  iters=5, warmup=1)
    qt = q.transpose(1, 2)
    kt, vt = (t[:, :kv_len].transpose(1, 2) for t in (k, v))
    mask = None
    if window or q_offset or kv_len != S:   # else SDPA's own causal path
        pos = q_offset + torch.arange(S, device="cuda")[:, None]
        kpos = torch.arange(kv_len, device="cuda")[None]
        mask = kpos <= pos if causal else torch.ones_like(kpos <= pos)
        if window:
            mask &= kpos > pos - window
    lms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=H != K))
    return err, tiled, kms, ems, pms, lms, call


def flash_bound(B, S, H, K, hd, elem, causal, window, peak, q_offset=0,
                kv_len=None):
    """Least time (ms) for the work, and what bounds it: matmul FLOPs over
    the visible (query, key) pairs (query s at position ``q_offset + s``,
    the first ``kv_len`` keys, default S) vs q and out, and the visible k
    and v, moved once."""
    kv_len = S if kv_len is None else kv_len
    pairs = 0
    for s in range(S):
        a = q_offset + s
        lo = max(0, a - window + 1) if window else 0
        hi = min(a + 1, kv_len) if causal else kv_len
        pairs += hi - lo
    flops = 4.0 * B * H * hd * pairs
    nbytes = elem * (2 * B * S * H * hd + 2 * B * kv_len * K * hd)
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def paged_case(pa, B, H, K, hd, page, s_max, dtype, seed, shuffle,
               lens=None):
    """One paged-attention comparison over a slot cache viewed as pages,
    at ``lens`` or at random lengths; returns (err, kernel_ms, eager
    kernel_ms, plain_ms, library_ms, seq_lens, the kernel call)."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    pages = s_max // page
    kc = torch.randn((B, s_max, K, hd), generator=g, device="cuda").to(dtype)
    vc = torch.randn((B, s_max, K, hd), generator=g, device="cuda").to(dtype)
    q = torch.randn((B, H, hd), generator=g, device="cuda").to(dtype)
    rng = np.random.default_rng(seed)
    if lens is None:
        lens = rng.integers(1, s_max + 1, size=B)
    lens = np.asarray(lens)
    seq_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    table = np.arange(B * pages, dtype=np.int32).reshape(B, pages)
    if shuffle:
        table = rng.permutation(B * pages).astype(np.int32).reshape(B, pages)
    table = torch.tensor(table, device="cuda")
    kp = kc.view(B * pages, page, K, hd)
    vp = vc.view(B * pages, page, K, hd)
    out = pa.paged_attention(q, kp, vp, table, seq_lens)
    ref = pa.paged_attention(q, kp, vp, table, seq_lens, impl="plain")
    torch.cuda.synchronize()
    err = max_err(out, ref)
    check(bool(torch.isfinite(out.float()).all()), "paged output finite")
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    check(err <= tol, f"paged {dtype} shuffle={shuffle} err {err:.3g} <= {tol}")

    def call():
        return pa.paged_attention(q, kp, vp, table, seq_lens)
    kms = time_ms(call)
    ems = time_ms(call, graph=False)
    pms = time_ms(lambda: pa.paged_attention(q, kp, vp, table, seq_lens,
                                             impl="plain"), iters=5, warmup=1)
    lms = None
    if not shuffle:     # identity table: the pool is the contiguous cache
        mask = (torch.arange(s_max, device="cuda")[None]
                < seq_lens[:, None])[:, None, None, :]
        qt = q[:, :, None, :]
        kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
        lms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=H != K))
    return err, kms, ems, pms, lms, lens, call


def paged_bound(B, H, K, hd, elem, lens):
    """Least time (ms): the K/V bytes of the tokens each sequence holds, q
    and out, and the 16-token pages' table entries, over HBM bandwidth
    (decode is bytes-bound: 4·H·hd FLOPs per token is far below the
    ridge)."""
    tokens = int(np.sum(lens))
    pages = int(np.sum(-(-np.asarray(lens) // 16)))
    nbytes = elem * (2 * tokens * K * hd + 2 * B * H * hd) + 4 * (pages + B)
    flops = 4.0 * tokens * H * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_PEAK_FLOPS
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ssd_inputs(b, S, H, P, G, N, dtype, seed):
    """x (b,S,H,P), dt (b,S,H) f32, A_log (H,), B, C (b,S,G,N) on the card,
    with mamba2's decay rates (A = 1..16) and softplus step sizes."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x = (torch.randn((b, S, H, P), generator=g, device="cuda") * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, S, H), generator=g, device="cuda"))
    A_log = torch.log(torch.linspace(1.0, 16.0, H, device="cuda"))
    B, C = ((torch.randn((b, S, G, N), generator=g, device="cuda") * 0.3)
            .to(dtype) for _ in range(2))
    return x, dt, A_log, B, C


def rel_err(a, b) -> float:
    """Largest absolute difference over the largest magnitude of ``b``."""
    return max_err(a, b) / max(float(b.float().abs().max()), 1e-30)


def ssd_chunk_case(so, b, S, H, P, G, N, Q, dtype, seed):
    """One SSD-chunk comparison (S a multiple of Q); returns (largest
    absolute error of the four outputs, largest error relative to each
    output's scale, worst |d| / (atol·max|ref| + rtol·|ref|) against the
    tiled plain version (bf16; None for f32), kernel_ms, eager kernel_ms,
    plain_ms, the kernel call)."""
    import torch
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_tiled_ref
    x, dt, A_log, B, C = ssd_inputs(b, S, H, P, G, N, dtype, seed)
    nc = S // Q
    args = (x.view(b, nc, Q, H, P), dt.view(b, nc, Q, H), A_log,
            B.view(b, nc, Q, G, N), C.view(b, nc, Q, G, N))
    out = so.ssd_chunk(*args)
    ref = so.ssd_chunk(*args, impl="plain")
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(o).all()) for o in out), "ssd finite")
    err = max(rel_err(o, r) for o, r in zip(out, ref))
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    check(err <= tol, f"ssd_chunk {dtype} b{b} S{S} Q{Q} rel err {err:.3g} "
                      f"<= {tol}")
    tiled = None
    if dtype == torch.bfloat16:
        tiled = max(float(((o - r).abs() / (SSD_TILED_ATOL * r.abs().max()
                                            + SSD_TILED_RTOL * r.abs())).max())
                    for o, r in zip(out, ssd_chunk_tiled_ref(*args)))
        check(tiled <= 1.0, f"ssd_chunk bf16 b{b} S{S} Q{Q} within "
                            f"{SSD_TILED_ATOL}·max|ref| + {SSD_TILED_RTOL}·"
                            f"|ref| of the tiled plain version (worst "
                            f"{tiled:.3g})")

    def call():
        return so.ssd_chunk(*args)
    kms = time_ms(call)
    ems = time_ms(call, graph=False)
    pms = time_ms(lambda: so.ssd_chunk(*args, impl="plain"), iters=5,
                  warmup=1)
    return (max(max_err(o, r) for o, r in zip(out, ref)), err, tiled, kms,
            ems, pms, call)


def ssd_scan_case(so, b, S, H, P, G, N, chunk, dtype, seed):
    """The whole scan (padded to whole chunks with dt = 0) through the
    kernel and through the plain version; returns the relative errors of y
    and of the final state."""
    import torch
    x, dt, A_log, B, C = ssd_inputs(b, S, H, P, G, N, dtype, seed)
    y, h = so.ssd(x, dt, A_log, B, C, chunk=chunk)
    yp, hp = so.ssd(x, dt, A_log, B, C, chunk=chunk, impl="plain")
    torch.cuda.synchronize()
    ey, eh = rel_err(y, yp), rel_err(h, hp)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    check(ey <= tol and eh <= tol, f"ssd scan {dtype} S{S} chunk{chunk} "
                                   f"rel err y {ey:.3g} state {eh:.3g} <= {tol}")
    return ey, eh


def ssd_bound(b, S, H, P, G, N, Q, elem, peak):
    """Least time (ms) of one ssd_chunk call, and what bounds it: x, B and C
    (read by group) in the input type, dt f32 and A_log read once; y,
    states and decays written once in f32; FLOPs of the causal half of
    C·Bᵀ and of (C·Bᵀ∘L)·(x·dt) plus the chunk-end state, per cell."""
    nc = S // Q
    nbytes = (elem * (b * S * H * P + 2 * b * S * G * N) + 4 * (b * S * H + H)
              + 4 * (b * S * H * P + b * nc * H * N * P + b * S * H
                     + b * nc * H))
    pairs = Q * (Q + 1) // 2
    flops = b * nc * H * (2.0 * pairs * (N + P) + 2.0 * Q * N * P)
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_ssd_kernel(so) -> tuple:
    """The SSD chunk kernel against its plain version at mamba2-370m's
    shapes (b=4, S=2048 and 1024, H=32, P=64, N=128, G=1, Q=256), then the
    whole scan at a ragged S and an S below one chunk.  Returns the bf16
    main case's row and its kernel call."""
    import torch
    b, H, P, G, N, Q = 4, 32, 64, 1, 128, 256
    row = call = None
    # the main case in both types, then the S = 1000 prefill as the kernel
    # sees it (padded to 4 chunks)
    for i, (S, dt) in enumerate(((2048, torch.bfloat16),
                                 (2048, torch.float32),
                                 (1024, torch.bfloat16))):
        aerr, err, tiled, kms, ems, pms, fn = ssd_chunk_case(
            so, b, S, H, P, G, N, Q, dt, seed=20 + i)
        elem = 2 if dt == torch.bfloat16 else 4
        peak = BF16_PEAK_FLOPS if dt == torch.bfloat16 else F32_PEAK_FLOPS
        bms, by = ssd_bound(b, S, H, P, G, N, Q, elem, peak)
        vs_tiled = (f" worst |d| / ({SSD_TILED_ATOL}·max|tiled| + "
                    f"{SSD_TILED_RTOL}·|tiled|) {tiled:.3g}"
                    if tiled is not None else "")
        print(f"[kernels] ssd_chunk b{b} S{S} H{H} P{P} G{G} N{N} Q{Q} "
              f"{str(dt)[6:]} (B, C read per group): max_abs_err {aerr:.3g} "
              f"max_rel_err {err:.3g}{vs_tiled} "
              f"kernel {kms:.4f} ms (eager timer {ems:.4f} ms) plain "
              f"{pms:.4f} ms library n/a (no single PyTorch call computes "
              f"SSD) bound {bms:.4f} ms ({by})")
        if row is None:
            row = dict(max_abs_err=aerr, ms=kms, eager_ms=ems, plain_ms=pms,
                       library_ms=None, bound_ms=bms, bound_by=by)
            call = fn
    for i, (S_, dt) in enumerate(((1000, torch.float32),
                                  (1000, torch.bfloat16),
                                  (200, torch.float32))):
        ey, eh = ssd_scan_case(so, b, S_, H, P, G, N, Q, dt, seed=30 + i)
        padded = -(-S_ // Q) * Q if S_ > Q else S_
        print(f"[kernels] ssd scan b{b} S{S_} chunk {Q} {str(dt)[6:]} "
              f"(kernel Q {min(Q, S_)}, padded to {padded}): rel err y "
              f"{ey:.3g} final state {eh:.3g}")
    return row, call


def phase_kernels(fa, pa) -> tuple:
    """Both attention kernels against their plain versions at the main
    path's shapes: the llama2 prefill buckets (B=8 S=128 to B=2 S=2048)
    and its decode slots (8 of 2048 tokens, random lengths and one long
    sequence among short ones).  Returns the main cases' rows and their
    kernel calls."""
    import torch
    rows, calls = {}, {}
    cases = [  # B, S, H, K, hd, dtype, causal, window
        (2, 1024, 40, 40, 128, torch.bfloat16, True, 0),    # main path
        (2, 1024, 40, 40, 128, torch.float32, True, 0),
        (2, 1024, 32, 8, 128, torch.bfloat16, True, 0),     # GQA
        (1, 1024, 40, 40, 128, torch.bfloat16, True, 256),  # window
        (2, 1000, 40, 40, 128, torch.float32, True, 0),     # ragged S
        (8, 128, 40, 40, 128, torch.bfloat16, True, 0),     # short bucket
        (2, 2048, 40, 40, 128, torch.bfloat16, True, 0),    # longest bucket
    ]
    for i, (B, S, H, K, hd, dt, causal, window) in enumerate(cases):
        err, tiled, kms, ems, pms, lms, call = flash_case(
            fa, B, S, H, K, hd, dt, causal, window, seed=i)
        elem = 2 if dt == torch.bfloat16 else 4
        peak = BF16_PEAK_FLOPS if dt == torch.bfloat16 else F32_PEAK_FLOPS
        bms, by = flash_bound(B, S, H, K, hd, elem, causal, window, peak)
        vs_tiled = (f" worst |d| / ({TILED_ATOL} + {TILED_RTOL}·|tiled|) "
                    f"{tiled:.3g}" if tiled is not None else "")
        print(f"[kernels] flash B{B} S{S} H{H} K{K} hd{hd} {str(dt)[6:]} "
              f"causal={causal} window={window}: max_abs_err {err:.3g}"
              f"{vs_tiled} kernel {kms:.4f} ms (eager timer {ems:.4f} ms) "
              f"plain {pms:.4f} ms sdpa {lms:.4f} ms bound {bms:.4f} ms "
              f"({by}); kernel / sdpa {kms / lms:.2f} (graph timer both)")
        if i == 0:
            rows["flash_attention"] = dict(max_abs_err=err, ms=kms,
                                           eager_ms=ems, plain_ms=pms,
                                           library_ms=lms,
                                           bound_ms=bms, bound_by=by)
            calls["flash_attention"] = call
    ocases = [  # C, q_offset, dtype, window: the chunks of the prefix serve
        (512, 1024, torch.bfloat16, 0),     # main offset case: a suffix chunk
        (512, 1024, torch.float32, 0),
        (1, 1500, torch.bfloat16, 0),       # a chunk of one token
        (1, 1500, torch.float32, 0),
        (200, 1500, torch.bfloat16, 0),     # C not a multiple of the tile
        (200, 1500, torch.float32, 0),
        (300, 700, torch.bfloat16, 256),    # window
        (300, 700, torch.float32, 256),
    ]
    T, H, K, hd = 2048, 40, 40, 128
    for i, (C, off, dt, window) in enumerate(ocases):
        kv_len = off + C
        err, tiled, kms, ems, pms, lms, call = flash_case(
            fa, 1, C, H, K, hd, dt, True, window, seed=40 + i, q_offset=off,
            T=T, kv_len=kv_len)
        elem = 2 if dt == torch.bfloat16 else 4
        peak = BF16_PEAK_FLOPS if dt == torch.bfloat16 else F32_PEAK_FLOPS
        bms, by = flash_bound(1, C, H, K, hd, elem, True, window, peak,
                              q_offset=off, kv_len=kv_len)
        vs_tiled = (f" worst |d| / ({TILED_ATOL} + {TILED_RTOL}·|tiled|) "
                    f"{tiled:.3g}" if tiled is not None else "")
        print(f"[kernels] flash offset B1 C{C} q_offset{off} kv_len{kv_len} "
              f"T{T} H{H} K{K} hd{hd} {str(dt)[6:]} window={window}: "
              f"max_abs_err {err:.3g}{vs_tiled} kernel {kms:.4f} ms (eager "
              f"timer {ems:.4f} ms) plain {pms:.4f} ms sdpa (boolean mask) "
              f"{lms:.4f} ms bound {bms:.4f} ms ({by}); kernel / sdpa "
              f"{kms / lms:.2f} (graph timer both)")
        if i == 0:
            rows["flash_attention_offset"] = dict(
                max_abs_err=err, ms=kms, eager_ms=ems, plain_ms=pms,
                library_ms=lms, bound_ms=bms, bound_by=by,
                case=f"B=1, C={C}, q_offset={off}, kv_len={kv_len}, T={T}, "
                     f"H=K={H}, hd={hd}, causal, bf16")
            calls["flash_attention_offset"] = call
    pcases = [(torch.bfloat16, False, None), (torch.float32, False, None),
              (torch.bfloat16, True, None), (torch.float32, True, None),
              (torch.bfloat16, False, LONG_AMONG_SHORT),
              (torch.float32, False, LONG_AMONG_SHORT)]
    B, H, K, hd, page, s_max = 8, 40, 40, 128, 16, 2048
    n_split = pa.split_count(s_max // page, page)
    for i, (dt, shuffle, lens) in enumerate(pcases):
        err, kms, ems, pms, lms, lens, call = paged_case(
            pa, B, H, K, hd, page, s_max, dt, seed=10 + i % 2,
            shuffle=shuffle, lens=lens)
        elem = 2 if dt == torch.bfloat16 else 4
        bms, by = paged_bound(B, H, K, hd, elem, lens)
        lib = f"{lms:.4f} ms" if lms is not None else "n/a"
        ratio = (f"; kernel / sdpa {kms / lms:.2f} (graph timer both)"
                 if lms is not None else "")
        print(f"[kernels] paged B{B} H{H} K{K} hd{hd} page{page} "
              f"s_max{s_max} {str(dt)[6:]} shuffled={shuffle} "
              f"lens={lens.tolist()} tokens={int(lens.sum())} ({n_split} "
              f"partitions of {pa.PARTITION} tokens): max_abs_err {err:.3g} "
              f"kernel {kms:.4f} ms (eager timer {ems:.4f} ms) plain "
              f"{pms:.4f} ms sdpa {lib} bound {bms:.4f} ms ({by}){ratio}")
        if i == 0:
            rows["paged_attention"] = dict(max_abs_err=err, ms=kms,
                                           eager_ms=ems, plain_ms=pms,
                                           library_ms=lms,
                                           bound_ms=bms, bound_by=by)
            calls["paged_attention"] = call
    return rows, calls


def phase_variants(calls: dict) -> dict:
    """Which device kernels each kernel's main case ran, read from the
    profiler: bf16 flash must run the tensor-core kernel alone, paged
    attention its split and merge kernels, bf16 SSD its two tensor-core
    kernels and nothing else."""
    want = {"flash_attention": ("flash_fwd_mma_kernel",),
            "flash_attention_offset": ("flash_fwd_mma_kernel",),
            "paged_attention": ("paged_split_kernel", "paged_merge_kernel"),
            "ssd_chunk": ("ssd_chunk_y_mma_kernel",
                          "ssd_chunk_state_mma_kernel")}
    variants = {}
    for name, call in calls.items():
        ran = launched_kernels(call)
        print(f"[variants] {name} main case ran {ran}")
        check(len(ran) == len(want[name])
              and all(any(w in r for r in ran) for w in want[name]),
              f"{name} main case ran {want[name]}")
        variants[name] = ", ".join(ran)
    return variants


def phase_parity_llama() -> None:
    """llama2-13b widths at 2 layers, f32: prefill + greedy decode through
    the kernels and through the plain versions."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import (DtypePolicy, decode_step,
                                    init_decode_caches, init_params, prefill)
    cfg = get_config("llama2-13b").scaled(n_layers=2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(cfg, gen, device="cuda", dtype=torch.float32)
    pol = DtypePolicy(torch.float32, torch.float32, torch.float32)
    rng = np.random.default_rng(0)
    B, S, s_max, steps = 2, 1024, 2048, 4
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                          device="cuda")
    results = {}
    for impl in (None, "plain"):
        logits, pc = prefill(params, {"tokens": tokens}, cfg, policy=pol,
                             impl=impl)
        caches = init_decode_caches(cfg, B, s_max, dtype=torch.float32,
                                    device="cuda")
        for dst, src in zip(caches, pc):
            for name in ("k", "v"):
                dst[name][:, :S].copy_(src[name])
        # Row 1 decodes from position 900: per-row positions differ, and
        # its cache past 900 is overwritten and masked as in the engine.
        pos = np.array([S, 900], dtype=np.int32)
        tok = logits.argmax(-1).to(torch.int32)
        seq, all_logits = [tok.cpu()], [logits]
        for _ in range(steps):
            logits, caches = decode_step(params, tok, caches, pos, cfg,
                                         policy=pol, impl=impl)
            tok = logits.argmax(-1).to(torch.int32)
            seq.append(tok.cpu())
            all_logits.append(logits)
            pos = pos + 1
        torch.cuda.synchronize()
        results[impl] = (torch.cat(seq, dim=1), all_logits)
    (tk, lk), (tp, lp) = results[None], results["plain"]
    err = max(max_err(a, b) for a, b in zip(lk, lp))
    print(f"[parity] llama2-13b full width, 2 layers, f32: tokens kernel "
          f"{tk.tolist()} plain {tp.tolist()}; max logit diff {err:.3g}")
    check(torch.equal(tk, tp), "kernel and plain greedy tokens equal")
    # 1e-3: two layers of f32 attention summed in another order
    check(err <= 1e-3, f"parity logits within 1e-3 (got {err:.3g})")
    check(all(bool(torch.isfinite(x).all()) for x in lk), "finite logits")
    phase_parity_llama_chunks(cfg, params, pol, rng)


def phase_parity_llama_chunks(cfg, params, pol, rng) -> None:
    """One prompt of 1024 + (0..100) tokens, fed through ``chunk_step`` in
    chunks of 512, 512 and the rest (each chunk at its offset, flash with
    a query offset over the slot cache) and through one prefill, both on
    the kernels, then greedy decode steps from each: equal tokens, logits
    within 1e-3."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import (chunk_step, decode_step,
                                    init_decode_caches, prefill)
    S = 1024 + int(rng.integers(0, 101))
    widths = [512, 512] + ([S - 1024] if S > 1024 else [])
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (1, S)),
                          device="cuda")
    results = {}
    off0 = fa.KERNEL.offset_launches
    for mode in ("prefill", "chunks"):
        caches = init_decode_caches(cfg, 1, 2048, dtype=torch.float32,
                                    device="cuda")
        if mode == "prefill":
            logits, pc = prefill(params, {"tokens": tokens}, cfg, policy=pol)
            for dst, src in zip(caches, pc):
                for name in ("k", "v"):
                    dst[name][:, :S].copy_(src[name])
        else:
            pos = 0
            for w in widths:
                logits, caches = chunk_step(params, tokens[:, pos:pos + w],
                                            caches, pos, cfg, policy=pol)
                pos += w
        tok = logits.argmax(-1).to(torch.int32)
        seq, all_logits = [tok.cpu()], [logits]
        for step in range(3):
            logits, caches = decode_step(params, tok, caches, S + step, cfg,
                                         policy=pol)
            tok = logits.argmax(-1).to(torch.int32)
            seq.append(tok.cpu())
            all_logits.append(logits)
        torch.cuda.synchronize()
        results[mode] = (torch.cat(seq, dim=1), all_logits)
    (tp_, lp), (tc, lc) = results["prefill"], results["chunks"]
    err = max(max_err(a, b) for a, b in zip(lc, lp))
    print(f"[parity] llama2-13b full width, 2 layers, f32, chunk_step in "
          f"chunks {widths} against one prefill of {S}: tokens chunks "
          f"{tc.tolist()} prefill {tp_.tolist()}; max logit diff {err:.3g}; "
          f"flash launches with an offset {fa.KERNEL.offset_launches - off0}")
    check(fa.KERNEL.offset_launches - off0 >= 2 * (len(widths) - 1),
          "chunks after the first launched flash with a query offset")
    check(torch.equal(tc, tp_), "chunked and prefill greedy tokens equal")
    # 1e-3: two layers of f32 attention over other key tilings
    check(err <= 1e-3, f"chunk parity logits within 1e-3 (got {err:.3g})")
    check(all(bool(torch.isfinite(x).all()) for x in lc), "finite logits")


def phase_parity_mamba2() -> None:
    """mamba2-370m widths at 2 layers, f32: one prefill of rows of
    different lengths (right-padded, with their true lengths) and greedy
    decode steps, through the SSD kernel and through its plain version."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import (DtypePolicy, decode_step,
                                    init_decode_caches, init_params, prefill)
    cfg = get_config("mamba2-370m").scaled(n_layers=2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(cfg, gen, device="cuda", dtype=torch.float32)
    pol = DtypePolicy(torch.float32, torch.float32, torch.float32)
    rng = np.random.default_rng(1)
    lens = np.array([1000, 512, 77], dtype=np.int32)   # 1000 % 256 != 0
    S, steps = int(lens.max()), 4
    toks = rng.integers(0, cfg.vocab_size, (len(lens), S))
    for i, n in enumerate(lens):
        toks[i, n:] = 0
    tokens = torch.tensor(toks, device="cuda")
    true_lens = torch.tensor(lens, device="cuda")
    results = {}
    for impl in (None, "plain"):
        logits, caches = prefill(params, {"tokens": tokens}, cfg, policy=pol,
                                 true_lens=true_lens, impl=impl)
        dec = init_decode_caches(cfg, len(lens), 2048, dtype=torch.float32,
                                 device="cuda")
        for dst, src in zip(dec, caches):
            for name in ("ssm", "conv"):
                dst[name].copy_(src[name])
        tok = logits.argmax(-1).to(torch.int32)
        seq, all_logits = [tok.cpu()], [logits]
        pos = lens.copy()
        for _ in range(steps):
            logits, dec = decode_step(params, tok, dec, pos, cfg, policy=pol,
                                      impl=impl)
            tok = logits.argmax(-1).to(torch.int32)
            seq.append(tok.cpu())
            all_logits.append(logits)
            pos = pos + 1
        torch.cuda.synchronize()
        results[impl] = (torch.cat(seq, dim=1), all_logits)
    (tk, lk), (tp, lp) = results[None], results["plain"]
    err = max(rel_err(a, b) for a, b in zip(lk, lp))
    print(f"[parity] mamba2-370m full width, 2 layers, f32, rows of "
          f"{lens.tolist()} tokens: tokens kernel {tk.tolist()} plain "
          f"{tp.tolist()}; max logit diff relative to scale {err:.3g}")
    check(torch.equal(tk, tp), "kernel and plain greedy tokens equal")
    # 1e-4: two layers of f32 SSD summed in another order
    check(err <= 1e-4, f"parity logits within 1e-4 of scale (got {err:.3g})")
    check(all(bool(torch.isfinite(x).all()) for x in lk), "finite logits")


def reset_counts(ops: dict) -> None:
    """Set every kernel's launch counts to 0."""
    for mod in ops.values():
        mod.KERNEL.launches = 0
    ops["flash_attention"].KERNEL.offset_launches = 0


def phase_serve(arch: str, ecfg, ops: dict, path: tuple) -> tuple:
    """``arch`` at full width and depth, bf16, EWSJF, on the card.  Every
    kernel count is set to 0 just before the run and read just after; the
    kernels in ``path`` must have launched.  Returns (the launches, the
    serve's result)."""
    import torch
    from repro_torch.launch.serve import card_requests
    from repro_torch.serving.api import serve
    reqs = card_requests()       # 24 at t=0: 19 short, 5 long
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    t0 = time.monotonic()
    out = serve(arch, reqs, smoke=False, scheduler="ewsjf",
                engine_config=ecfg, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: mod.KERNEL.launches for name, mod in ops.items()}
    eng, st = out["engine"], out["stats"]
    fin = out["finished"]
    check(len(fin) == len(reqs), f"all {len(reqs)} requests finished "
                                 f"(got {len(fin)})")
    for r in fin:
        toks = eng.output_tokens.get(r.request_id, [])
        check(len(toks) == r.max_new_tokens == r.generated,
              f"request {r.request_id} generated all its tokens")
        check(all(0 <= t < eng.cfg.vocab_size for t in toks),
              "token ids inside the vocabulary")
    for name in path:
        check(launches[name] > 0, f"{name} launched on the {arch} path")
    cfg = eng.cfg
    short = [r.ttft for r in fin if r.prompt_len <= 128]
    long_ = [r.ttft for r in fin if r.prompt_len > 128]
    print(f"[serve] {arch} {cfg.n_layers} layers d{cfg.d_model} bf16 EWSJF: "
          f"{len(fin)} "
          f"requests, {sum(r.generated for r in fin)} tokens in "
          f"{st['elapsed_s']:.2f} s engine time ({wall:.2f} s with weight "
          f"init): {st['tok_per_s']:.1f} tok/s; mean TTFT short "
          f"{np.mean(short):.3f} s long {np.mean(long_):.3f} s; prefill "
          f"batches {st['prefill_batches']} padding_waste "
          f"{st['padding_waste']:.3f} preemptions {st['preemptions']}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
          f"launches {launches}")
    return launches, out


def phase_prefix_serve(params, ops: dict) -> dict:
    """llama2-13b at full width and depth (``params``, bf16) in chunked
    prefill + radix reuse mode (``card_prefix_engine_config``) over
    shared-prefix traffic (``card_prefix_requests``: one 1024-token prefix,
    16-128-token suffixes).  Counts are set to 0 just before the run and
    read just after: flash (also with a query offset) and paged attention
    must have launched.  Every request must finish with all its tokens, at
    least 16 must attach the whole prefix (``cached_len == 1024``), the
    radix must keep its invariants and the pool must hold nothing but radix
    tenancy.  Returns the launches."""
    import resource

    import torch
    from repro_torch.launch.serve import (card_prefix_engine_config,
                                          card_prefix_requests)
    from repro_torch.serving.api import serve
    reqs = card_prefix_requests()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    t0 = time.monotonic()
    out = serve("llama2-13b", reqs, smoke=False, scheduler="ewsjf",
                params=params, engine_config=card_prefix_engine_config(),
                device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: mod.KERNEL.launches for name, mod in ops.items()}
    launches["flash_attention_offset"] = \
        ops["flash_attention"].KERNEL.offset_launches
    eng, st = out["engine"], out["stats"]
    fin = out["finished"]
    check(len(fin) == len(reqs), f"all {len(reqs)} prefix requests finished "
                                 f"(got {len(fin)})")
    for r in fin:
        toks = eng.output_tokens.get(r.request_id, [])
        check(len(toks) == r.max_new_tokens == r.generated,
              f"prefix request {r.request_id} generated all its tokens")
        check(all(0 <= t < eng.cfg.vocab_size for t in toks),
              "token ids inside the vocabulary")
    attached = [r for r in fin if r.cached_len == 1024]
    check(len(attached) >= 16, f"at least 16 requests attached the 1024-"
                               f"token prefix (got {len(attached)})")
    for name in ("flash_attention", "paged_attention",
                 "flash_attention_offset"):
        check(launches[name] > 0, f"{name} launched on the prefix path")
    eng.radix.check_invariants()
    leftover = {k: v for k, v in eng.pool.allocs.items()
                if not isinstance(k, tuple)}
    check(leftover == {}, f"only radix tenancy left in the pool (got "
                          f"{leftover})")
    full = [r.ttft for r in fin if r.cached_len < 1024]
    cp = st["radix_copies"]
    host_runs = {id(h): h for h, _ in eng._node_kv.values()}
    host_bytes = sum(t.nbytes for run in host_runs.values() for t in run)
    peak_dev = torch.cuda.max_memory_allocated() / 2**30
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"[serve] llama2-13b chunked+radix {eng.cfg.n_layers} layers "
          f"d{eng.cfg.d_model} bf16 EWSJF, chunks of "
          f"{eng.e.chunk_prefill_tokens}: {len(fin)} requests, "
          f"{sum(r.generated for r in fin)} tokens in {st['elapsed_s']:.2f} s "
          f"engine time ({wall:.2f} s): {st['tok_per_s']:.1f} tok/s; mean "
          f"TTFT suffix-only ({len(attached)} requests) "
          f"{np.mean([r.ttft for r in attached]):.3f} s, whole prompt "
          f"({len(full)}) {np.mean(full) if full else float('nan'):.3f} s; "
          f"chunks {st['chunks']} ({st['chunk_tokens']} tokens), "
          f"prefix_saved_tokens {st['prefix_saved_tokens']}, "
          f"interleaved_ticks {st['interleaved_ticks']}, preemptions "
          f"{st['preemptions']}; radix {st['radix']}")
    for way, label in (("d2h", "device to host (publish)"),
                       ("h2d", "host to device (attach)")):
        rate = cp[f"{way}_bytes"] / max(cp[f"{way}_s"], 1e-12) / 1e9
        print(f"[serve]   radix block copies {label}: {cp[f'{way}_blocks']} "
              f"blocks, {cp[f'{way}_bytes'] / 1e9:.3f} GB in "
              f"{cp[f'{way}_s']:.4f} s ({rate:.1f} GB/s)")
    print(f"[serve]   peak device memory {peak_dev:.1f} GiB; host KV store "
          f"{host_bytes / 1e9:.3f} GB in {len(host_runs)} runs; process peak "
          f"RSS {rss:.1f} GiB; launches {launches}")
    return launches


def attention_launches(ops: dict) -> dict:
    """The attention kernels' counts since the last ``reset_counts``."""
    return {"flash_attention": ops["flash_attention"].KERNEL.launches,
            "flash_attention_offset":
                ops["flash_attention"].KERNEL.offset_launches,
            "paged_attention": ops["paged_attention"].KERNEL.launches}


def phase_replay(cfg, params, ops: dict) -> dict:
    """DES↔engine replay at full width: ``card_trace`` (24 requests at t=0,
    a quarter of 700-1900 prompt tokens) through the DES (H100 roofline)
    and the torch engine (``params``, ``card_engine_config``) under FCFS,
    SJF and EWSJF, each a ``serving.replay.run_replay`` call with the
    counts set to 0 just before it and read just after.  Each must pass
    ``replay_ok`` (FCFS and SJF dispatch equal to the DES, EWSJF's rank
    correlation at least ``TAU_BOUND``), finish 24 of 24 in both executors
    and launch both attention kernels; where the greedy tokens of a request
    differ between runs, they must part at a near-tie
    (``check_tokens_agree``).  Returns the launches by scheduler."""
    import torch
    from repro_torch.launch.replay_trace import card_trace, ttft_by_class
    from repro_torch.launch.serve import card_engine_config
    from repro_torch.serving.replay import (EXACT_SCHEDULERS, SCHEDULERS,
                                            TAU_BOUND, replay_ok, run_replay)
    ecfg = card_engine_config()
    check(ecfg.kv_pool_tokens >= ecfg.max_slots * ecfg.s_max,
          "replay pool holds every slot: no pool pressure")
    trace = card_trace(24, 0, cfg.vocab_size)
    n_long = sum(r.prompt_len > 128 for r in trace)
    launches, tokens = {}, {}
    torch.cuda.reset_peak_memory_stats()
    for name in SCHEDULERS:
        reset_counts(ops)
        t0 = time.monotonic()
        rep = run_replay(trace, name, arch="llama2-13b", ecfg=ecfg,
                         params=params, cfg=cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches[name] = attention_launches(ops)
        check(rep["des_finished"] == rep["engine_finished"] == len(trace),
              f"replay {name}: {len(trace)} of {len(trace)} finished in both "
              f"executors (DES {rep['des_finished']}, engine "
              f"{rep['engine_finished']})")
        if name in EXACT_SCHEDULERS:
            check(rep["dispatch_match"], f"replay {name}: engine dispatch "
                  f"{rep['engine_dispatch']} equals the DES's "
                  f"{rep['des_dispatch']}")
        else:
            check(rep["dispatch_tau"] >= TAU_BOUND,
                  f"replay {name}: dispatch_tau {rep['dispatch_tau']:.3f} "
                  f">= {TAU_BOUND}")
        check(replay_ok(rep), f"replay {name}: replay_ok")
        for path in ("flash_attention", "paged_attention"):
            check(launches[name][path] > 0,
                  f"{path} launched in the {name} replay")
        for r in trace:
            toks = rep["engine_tokens"][str(r.request_id)]
            check(len(toks) == r.max_new_tokens
                  and all(0 <= t < cfg.vocab_size for t in toks),
                  f"replay {name}: request {r.request_id} generated all its "
                  f"tokens inside the vocabulary")
        tokens[name] = rep["engine_tokens"]
        eng, des = ttft_by_class(rep, trace), ttft_by_class(rep, trace, "des")
        print(f"[replay] llama2-13b {cfg.n_layers} layers d{cfg.d_model} "
              f"{str(params.embed.dtype)[6:]} "
              f"{name}: {rep['engine_finished']} requests ({n_long} long) in "
              f"{rep['engine_elapsed_s']:.2f} s engine time ({wall:.2f} s "
              f"with the DES); dispatch {'match' if rep['dispatch_match'] else 'diverge'} "
              f"dispatch_tau {rep['dispatch_tau']:.3f} ttft_tau "
              f"{rep['ttft_tau']:.3f}; engine TTFT short mean "
              f"{eng['short']['mean']:.3f} s p95 {eng['short']['p95']:.3f} s, "
              f"long mean {eng['long']['mean']:.3f} s p95 "
              f"{eng['long']['p95']:.3f} s; {rep['engine_tok_per_s']:.1f} "
              f"tok/s; DES (H100 roofline) mean TTFT short "
              f"{des['short']['mean']:.4f} s long {des['long']['mean']:.4f} s; "
              f"launches flash {launches[name]['flash_attention']} paged "
              f"{launches[name]['paged_attention']}")
        print(f"[replay]   {name} dispatch engine {rep['engine_dispatch']} "
              f"DES {rep['des_dispatch']}")
    check_tokens_agree(cfg, params, trace, tokens)
    print(f"[replay] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return launches


def next_token_logits(cfg, params, prompt, pad_to=None, beside=None):
    """Logits (f32) of the token after ``prompt`` from one prefill of it
    alone or, with ``pad_to``, as row 0 of a 2-row batch right-padded to
    ``pad_to`` positions beside ``beside``'s first ``pad_to`` tokens."""
    import torch
    from repro_torch.models import DtypePolicy, prefill
    n = len(prompt)
    rows = [np.asarray(prompt)]
    lens = [n]
    if pad_to is not None:
        rows = [np.pad(rows[0], (0, pad_to - n)), np.asarray(beside)[:pad_to]]
        lens.append(pad_to)
    tokens = torch.tensor(np.stack(rows), dtype=torch.int64, device="cuda")
    dt = params.embed.dtype
    logits, _ = prefill(params, {"tokens": tokens}, cfg,
                        policy=DtypePolicy(dt, dt, torch.float32),
                        true_lens=torch.tensor(lens, device="cuda"))
    return logits[0, 0].float()


def check_tokens_agree(cfg, params, trace, tokens: dict) -> None:
    """Greedy tokens of every request under each scheduler against the
    first scheduler's.  In bf16 a request's logits move with the shape of
    the prefill batch it rode in (which differs by scheduler), so two runs
    may part at a near-tie.  The bound is measured here: ``noise`` is the
    largest difference of any request's first-token logits between a
    prefill of its prompt alone and one as a row of a batch padded to 2048
    positions.  Where two runs part, the request's logits after the common
    tokens (prefilled alone) must hold both tokens within 2·noise of the
    largest logit, as each run's choice allows; a wrong cache or position
    would part the runs far from any tie."""
    from repro_torch.serving.replay import SCHEDULERS
    longest = max(trace, key=lambda r: r.prompt_len).prompt_tokens
    pad = 2048
    noise = 0.0
    for r in trace:
        if r.prompt_len < len(longest) and r.prompt_len < pad:
            a = next_token_logits(cfg, params, r.prompt_tokens)
            b = next_token_logits(cfg, params, r.prompt_tokens, pad,
                                  np.resize(longest, pad))
            noise = max(noise, float((a - b).abs().max()))
    base = SCHEDULERS[0]
    parted = 0
    for name in SCHEDULERS[1:]:
        for r in trace:
            ta, tb = tokens[base][str(r.request_id)], tokens[name][str(r.request_id)]
            if ta == tb:
                continue
            parted += 1
            k = next(i for i in range(len(ta)) if ta[i] != tb[i])
            seq = np.concatenate([r.prompt_tokens,
                                  np.asarray(ta[:k], dtype=np.int32)])
            lg = next_token_logits(cfg, params, seq)
            margin = float(lg.max() - min(lg[ta[k]], lg[tb[k]]))
            print(f"[replay]   {base} and {name} part on request "
                  f"{r.request_id} at token {k}: {ta[k]} against {tb[k]}, "
                  f"logits alone {float(lg[ta[k]]):.4f} and "
                  f"{float(lg[tb[k]]):.4f}, largest {float(lg.max()):.4f}")
            check(margin <= 2 * noise,
                  f"replay {name}: request {r.request_id} parts from "
                  f"{base} at a near-tie (margin {margin:.4f} <= 2 x "
                  f"{noise:.4f})")
    print(f"[replay] greedy tokens under {', '.join(SCHEDULERS)}: "
          f"{parted} of {len(trace) * (len(SCHEDULERS) - 1)} request pairs "
          f"part from {base}'s, each at a near-tie; bf16 first-token logits "
          f"move by up to {noise:.4f} with the prefill batch's shape")


def phase_fleet(cfg, params, ops: dict) -> dict:
    """Two torch engines in chunked+radix mode (``card_prefix_engine_config``,
    EWSJF each) sharing the one set of ``params``, behind
    ``cluster.EngineFleet`` with ``EWSJFRouter``, ``HealthMonitor``, a
    ``PrefixDirectory`` synced every round and a ``LinkTopology`` at the
    port's defaults, over ``card_prefix_requests(24)`` (one shared
    1024-token prefix).  The first request is served alone and its engine
    advertises the prefix; the other 23 are then routed at once, so the
    router plans a remote prefix fetch for the other engine, which ships
    the holder's host KV blocks into that engine's radix.  Counts are set to
    0 before the first request and read after the last.  Checks: 24 of 24
    finish, none lost or dispatched twice, both engines dispatched, at
    least one fetch whose bytes are its blocks × 16 tokens × the KV bytes a
    token takes, the fetched request attached 1024 cached tokens, clean
    radix invariants and no pins left on both engines, shared weights, and
    peak device memory under 75 GiB.  Returns the launches."""
    import torch
    from repro_torch.cluster import (EngineFleet, EWSJFRouter, HealthConfig,
                                     HealthMonitor)
    from repro_torch.core import CostModel, RequestState
    from repro_torch.kvplane import (LinkTopology, PrefixDirectory,
                                     PrefixDirectoryConfig)
    from repro_torch.launch.serve import (card_prefix_engine_config,
                                          card_prefix_requests,
                                          make_scheduler)
    from repro_torch.models import DtypePolicy
    from repro_torch.serving import ServingEngine
    torch.cuda.reset_peak_memory_stats()
    dt = params.embed.dtype
    engines = []
    for eid in range(2):
        ecfg = card_prefix_engine_config()
        ecfg.engine_id = eid
        engines.append(ServingEngine(cfg, params, make_scheduler("ewsjf"),
                                     ecfg, policy=DtypePolicy(dt, dt,
                                                              torch.float32),
                                     device="cuda"))
    w0, w1 = (e.params.blocks[0].mixer["wq"] for e in engines)
    check(w0.data_ptr() == w1.data_ptr()
          and engines[0].params.embed.data_ptr()
          == engines[1].params.embed.data_ptr(),
          "both engines share one set of weights")
    cost = CostModel()
    fleet = EngineFleet(
        engines, router=EWSJFRouter(cost=cost), cost=cost,
        monitor=HealthMonitor(HealthConfig()),
        directory=PrefixDirectory(PrefixDirectoryConfig(sync_interval=0.0)),
        topology=LinkTopology())
    reqs = card_prefix_requests(24, vocab=cfg.vocab_size)
    warm, rest = reqs[0], reqs[1:]
    reset_counts(ops)
    t0 = time.monotonic()
    fleet.submit(warm)
    for _ in range(2000):
        if warm.state == RequestState.FINISHED:
            break
        fleet.step()
    check(warm.state == RequestState.FINISHED,
          "the first request finished alone")
    fleet.prefix_sync()
    holders = fleet.directory.advertised_replicas()
    check(len(holders) == 1, f"one engine advertises the prefix (got "
                             f"{sorted(holders)})")
    fetched = []
    for r in rest:
        before = fleet.stats.prefix_fetches
        fleet.submit(r)
        if fleet.stats.prefix_fetches > before:
            fetched.append(r)
    # the body of EngineFleet.serve, whose end test would count the first
    # request among these
    last_health = fleet.now()
    for _ in range(20000):
        now = fleet.now()
        if now - last_health >= fleet.monitor.cfg.check_interval:
            fleet.health_round(now)
            last_health = now
        if fleet.directory.due(now):
            fleet.prefix_sync(now)
        fleet.step()
        if all(r.state == RequestState.FINISHED for r in reqs):
            break
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = attention_launches(ops)
    res = fleet.result()
    fin = fleet.finished()
    check(sorted(r.request_id for r in fin)
          == sorted(r.request_id for r in reqs) and res["shed"] == 0,
          f"all {len(reqs)} fleet requests finished once (finished "
          f"{res['finished']}, shed {res['shed']})")
    dispatched = [rid for e in engines for _, rid in e.dispatch_log]
    preempted = sum(e.preemptions for e in engines)
    check(len(dispatched) == len(reqs) + preempted
          and set(dispatched) == {r.request_id for r in reqs},
          f"no request lost or dispatched twice ({len(dispatched)} "
          f"dispatches, {preempted} preemptions)")
    check(all(e.dispatch_log for e in engines), "both engines dispatched")
    for r in fin:
        toks = next(e for e in engines
                    if r in e.finished).output_tokens[r.request_id]
        check(len(toks) == r.max_new_tokens == r.generated
              and all(0 <= t < cfg.vocab_size for t in toks),
              f"fleet request {r.request_id} generated all its tokens")
    block_bytes = (cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim
                   * torch.finfo(dt).bits // 8)
    check(res["prefix_fetches"] >= 1 and fetched,
          f"the router planned at least one remote prefix fetch (got "
          f"{res['prefix_fetches']})")
    check(res["prefix_fetch_bytes"]
          == res["prefix_fetch_blocks"] * 16 * block_bytes > 0,
          f"prefix_fetch_bytes {res['prefix_fetch_bytes']} = blocks "
          f"{res['prefix_fetch_blocks']} x 16 x {block_bytes}")
    check(all(r.cached_len == 1024 for r in fetched),
          f"the fetched requests attached 1024 cached tokens (got "
          f"{[r.cached_len for r in fetched]})")
    for e in engines:
        e.radix.check_invariants()
        check(all(nd.pins == 0 for nd in e.radix._nodes.values()),
              f"no pins left on engine {e.e.engine_id}")
    for path in ("flash_attention", "paged_attention",
                 "flash_attention_offset"):
        check(launches[path] > 0, f"{path} launched in the fleet")
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(peak < 75, f"fleet peak device memory {peak:.1f} GiB < 75")
    toks = sum(r.generated for r in fin)
    per = {eid: (st["dispatched"], st["finished"], st["prefix_saved_tokens"])
           for eid, st in res["engines"].items()}
    print(f"[fleet] llama2-13b {cfg.n_layers} layers d{cfg.d_model} "
          f"{str(dt)[6:]}, 2 "
          f"engines sharing one set of weights (EWSJF each, EWSJFRouter): "
          f"{len(fin)} requests, {toks} tokens in {wall:.2f} s "
          f"({toks / wall:.1f} tok/s); per engine (dispatched, finished, "
          f"prefix_saved_tokens) {per}; holder {sorted(holders)}; "
          f"prefix fetches {res['prefix_fetches']} of "
          f"{res['prefix_fetch_blocks']} blocks, {res['prefix_fetch_bytes']} "
          f"B host KV ({res['prefix_fetch_bytes'] / 1e6:.1f} MB; "
          f"{block_bytes * 16 / 1e6:.2f} MB a block), exposed "
          f"{res['prefix_fetch_exposed_s'] * 1e3:.3f} ms on the link model; "
          f"fetched requests (trace positions) "
          f"{[reqs.index(r) for r in fetched]} cached_len "
          f"{[r.cached_len for r in fetched]}; mean TTFT "
          f"{np.mean([r.ttft for r in fin]):.3f} s; peak device memory "
          f"{peak:.1f} GiB; launches {launches}")
    del fleet, engines
    gc.collect()
    return launches


def main() -> int:
    """Run every phase; return the exit code."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # Full f32 for every f32 product (the plain versions are references).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build as kbuild
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.ssd_scan import ops as so
    from repro_torch.launch.serve import (card_engine_config,
                                          ssm_card_engine_config)

    t_start = time.monotonic()
    phase_setup(kbuild)
    rows, calls = phase_kernels(fa, pa)
    rows["ssd_chunk"], calls["ssd_chunk"] = phase_ssd_kernel(so)
    phase_parity_llama()
    phase_parity_mamba2()
    torch.cuda.empty_cache()
    ops = {"flash_attention": fa, "paged_attention": pa, "ssd_chunk": so}
    llama, out = phase_serve("llama2-13b", card_engine_config(), ops,
                             ("flash_attention", "paged_attention"))
    # the prefix, replay and fleet runs reuse these weights
    params, cfg = out["engine"].params, out["engine"].cfg
    del out
    gc.collect()
    torch.cuda.empty_cache()
    prefix = phase_prefix_serve(params, ops)
    gc.collect()
    torch.cuda.empty_cache()
    replay = phase_replay(cfg, params, ops)
    gc.collect()
    torch.cuda.empty_cache()
    fleet = phase_fleet(cfg, params, ops)
    del params                         # the weights, engines and stores go
    gc.collect()
    torch.cuda.empty_cache()
    mamba, _ = phase_serve("mamba2-370m", ssm_card_engine_config(), ops,
                           ("ssd_chunk",))
    # after every timed phase: the profiler runs in this process only here
    variants = phase_variants(calls)
    # each kernel's launches come from the run of its own path
    launches = {"flash_attention": llama["flash_attention"],
                "paged_attention": llama["paged_attention"],
                "ssd_chunk": mamba["ssd_chunk"]}
    # and, beside them, from each later path's run
    by_path = {name: {"serve": launches[name]} for name in launches}
    for name in ("flash_attention", "paged_attention"):
        by_path[name]["prefix"] = prefix[name]
        for sched, counts in replay.items():
            by_path[name][f"replay_{sched}"] = counts[name]
        by_path[name]["fleet"] = fleet[name]
    sources = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention/kernel.py:88"),
               "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention/kernel.py:75"),
               "ssd_chunk": ("src/repro_torch/csrc/ssd_scan.cu",
                             "src/repro/kernels/ssd_scan/kernel.py:66")}
    kernels = []
    for name, (source, replaces) in sources.items():
        r = rows[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "library_ms": r["library_ms"]}
        entry["launches_by_path"] = by_path[name]
        if name in variants:
            entry["variant"] = variants[name]
        if name == "flash_attention":
            o = rows["flash_attention_offset"]
            entry["offset_case"] = {
                "case": o["case"],
                "launches": prefix["flash_attention_offset"],
                "launches_all": prefix["flash_attention"],
                "max_abs_err": o["max_abs_err"], "ms": o["ms"],
                "plain_ms": o["plain_ms"], "bound_ms": o["bound_ms"],
                "bound_by": o["bound_by"], "library_ms": o["library_ms"],
                "variant": variants["flash_attention_offset"]}
        kernels.append(entry)
    print(f"[summary] all phases passed in {time.monotonic() - t_start:.1f} s")
    print("[summary] recorded, not measured in this run: main-case ms of "
          "the replaced designs (PERF.md section 6) by timer "
          + json.dumps(RECORDED_EARLIER_MS))
    for name, earlier in RECORDED_EARLIER_MS.items():
        now = {"eager": rows[name]["eager_ms"], "graph": rows[name]["ms"]}
        print(f"[summary] {name}: " + "; ".join(
            f"{timer} timer: recorded {ms:.4f} ms, this run "
            f"{now[timer]:.4f} ms, recorded / this run {ms / now[timer]:.2f}"
            for timer, ms in earlier.items()))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
