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
   included); bf16 flash is also held element by element against
   ``flash_attention_tiled_ref``, and the bf16 SSD main case against
   ``ssd_chunk_tiled_ref``, each of which rounds what its kernel rounds.
   Times kernel (graph and eager timers), plain version, the least time the
   card could take (bound) and, for attention,
   ``torch.nn.functional.scaled_dot_product_attention`` (a yardstick only:
   the port never calls it; no single PyTorch call computes SSD);
3. parity: llama2-13b and mamba2-370m at full width and 2 layers, in f32 —
   one prefill and a few greedy decode steps through the kernels and
   through the plain versions must give the same tokens and close logits;
4. serve: ``repro_torch.serving.api.serve`` runs llama2-13b, then
   mamba2-370m, at full width and depth (random bf16 weights from a seed)
   under EWSJF over a mixed short/long workload; every request must finish
   and each path's kernels must have launched in its own run;
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


def flash_case(fa, B, S, H, K, hd, dtype, causal, window, seed):
    """One flash-attention comparison; returns (max_abs_err, worst
    |d| / (atol + rtol·|ref|) against the tiled plain version (bf16; None
    for f32), kernel_ms, eager kernel_ms, plain_ms, library_ms, the kernel
    call)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_tiled_ref)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q = torch.randn((B, S, H, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, S, K, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, S, K, hd), generator=g, device="cuda").to(dtype)
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    ref = fa.flash_attention(q, k, v, causal=causal, window=window,
                             impl="plain")
    torch.cuda.synchronize()
    err = max_err(out, ref)
    check(bool(torch.isfinite(out.float()).all()), "flash output finite")
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    check(err <= tol, f"flash {dtype} B{B} S{S} H{H} K{K} w{window} err "
                      f"{err:.3g} <= {tol}")
    tiled = None
    if dtype == torch.bfloat16:
        ref_t = flash_attention_tiled_ref(
            *(t.transpose(1, 2) for t in (q, k, v)), causal=causal,
            window=window).transpose(1, 2).float()
        tiled = float(((out.float() - ref_t).abs()
                       / (TILED_ATOL + TILED_RTOL * ref_t.abs())).max())
        check(tiled <= 1.0, f"flash bf16 B{B} S{S} H{H} K{K} w{window} "
                            f"within {TILED_ATOL} + {TILED_RTOL}·|ref| of "
                            f"the tiled plain version (worst {tiled:.3g})")

    def call():
        return fa.flash_attention(q, k, v, causal=causal, window=window)
    kms = time_ms(call)
    ems = time_ms(call, graph=False)
    pms = time_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                             window=window, impl="plain"),
                  iters=5, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if window:
        pos = torch.arange(S, device="cuda")
        mask = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - window)
    lms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=H != K))
    return err, tiled, kms, ems, pms, lms, call


def flash_bound(B, S, H, K, hd, elem, causal, window, peak):
    """Least time (ms) for the work, and what bounds it: matmul FLOPs over
    the visible (query, key) pairs vs q/k/v read once and out written once."""
    pairs = 0
    for s in range(S):
        lo = max(0, s - window + 1) if window else 0
        hi = s + 1 if causal else S
        pairs += hi - lo
    flops = 4.0 * B * H * hd * pairs
    nbytes = elem * (2 * B * S * H * hd + 2 * B * S * K * hd)
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


def phase_serve(arch: str, ecfg, ops: dict, path: tuple) -> dict:
    """``arch`` at full width and depth, bf16, EWSJF, on the card.  Every
    kernel count is set to 0 just before the run and read just after; the
    kernels in ``path`` must have launched."""
    import torch
    from repro_torch.launch.serve import card_requests
    from repro_torch.serving.api import serve
    reqs = card_requests()       # 24 at t=0: 19 short, 5 long
    torch.cuda.reset_peak_memory_stats()
    for mod in ops.values():
        mod.KERNEL.launches = 0
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
    llama = phase_serve("llama2-13b", card_engine_config(), ops,
                        ("flash_attention", "paged_attention"))
    torch.cuda.empty_cache()
    mamba = phase_serve("mamba2-370m", ssm_card_engine_config(), ops,
                        ("ssd_chunk",))
    # after every timed phase: the profiler runs in this process only here
    variants = phase_variants(calls)
    # each kernel's launches come from the run of its own path
    launches = {"flash_attention": llama["flash_attention"],
                "paged_attention": llama["paged_attention"],
                "ssd_chunk": mamba["ssd_chunk"]}
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
        if name in variants:
            entry["variant"] = variants[name]
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
