#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. setup: print the card's name and power limit, build both CUDA kernels
   from ``src/repro_torch/csrc`` (one ``nvcc`` each, in parallel);
2. kernels: hold flash attention and paged attention against their plain
   PyTorch versions on the card at the main path's shapes, and time kernel,
   plain version and ``torch.nn.functional.scaled_dot_product_attention``
   (a yardstick only: the port never calls it);
3. parity: llama2-13b at full width and 2 layers, in f32 — one prefill and
   a few greedy decode steps through the kernels and through the plain
   versions must give the same tokens and close logits;
4. serve: ``repro_torch.serving.api.serve`` runs llama2-13b at full width
   and depth (random bf16 weights from a seed) under EWSJF over a mixed
   short/long workload; every request must finish and both kernels must
   have launched;
5. summary: one JSON line of per-kernel numbers, then the last line
   ``{"ok": true, "device": {...}}``.

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


def check(cond: bool, what: str) -> None:
    """Raise when a phase's condition fails."""
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    """One flash-attention comparison; returns (max_abs_err, kernel_ms,
    plain_ms, library_ms)."""
    import torch
    import torch.nn.functional as F
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
    kms = time_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                             window=window))
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
    return err, kms, pms, lms


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


def paged_case(pa, B, H, K, hd, page, s_max, dtype, seed, shuffle):
    """One paged-attention comparison over a slot cache viewed as pages;
    returns (err, kernel_ms, plain_ms, library_ms, seq_lens)."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    pages = s_max // page
    kc = torch.randn((B, s_max, K, hd), generator=g, device="cuda").to(dtype)
    vc = torch.randn((B, s_max, K, hd), generator=g, device="cuda").to(dtype)
    q = torch.randn((B, H, hd), generator=g, device="cuda").to(dtype)
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, s_max + 1, size=B)
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
    kms = time_ms(lambda: pa.paged_attention(q, kp, vp, table, seq_lens))
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
    return err, kms, pms, lms, lens


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


def phase_kernels(fa, pa) -> dict:
    """Both kernels against their plain versions at the main path's shapes."""
    import torch
    rows = {}
    cases = [  # B, S, H, K, hd, dtype, causal, window
        (2, 1024, 40, 40, 128, torch.bfloat16, True, 0),    # main path
        (2, 1024, 40, 40, 128, torch.float32, True, 0),
        (2, 1024, 32, 8, 128, torch.bfloat16, True, 0),     # GQA
        (1, 1024, 40, 40, 128, torch.bfloat16, True, 256),  # window
        (2, 1000, 40, 40, 128, torch.float32, True, 0),     # ragged S
    ]
    for i, (B, S, H, K, hd, dt, causal, window) in enumerate(cases):
        err, kms, pms, lms = flash_case(fa, B, S, H, K, hd, dt, causal,
                                        window, seed=i)
        elem = 2 if dt == torch.bfloat16 else 4
        peak = BF16_PEAK_FLOPS if dt == torch.bfloat16 else F32_PEAK_FLOPS
        bms, by = flash_bound(B, S, H, K, hd, elem, causal, window, peak)
        print(f"[kernels] flash B{B} S{S} H{H} K{K} hd{hd} {str(dt)[6:]} "
              f"causal={causal} window={window}: max_abs_err {err:.3g} "
              f"kernel {kms:.4f} ms plain {pms:.4f} ms sdpa {lms:.4f} ms "
              f"bound {bms:.4f} ms ({by})")
        if i == 0:
            rows["flash_attention"] = dict(max_abs_err=err, ms=kms,
                                           plain_ms=pms, library_ms=lms,
                                           bound_ms=bms, bound_by=by)
    pcases = [(torch.bfloat16, False), (torch.float32, False),
              (torch.bfloat16, True), (torch.float32, True)]
    for i, (dt, shuffle) in enumerate(pcases):
        B, H, K, hd, page, s_max = 8, 40, 40, 128, 16, 2048
        err, kms, pms, lms, lens = paged_case(pa, B, H, K, hd, page, s_max,
                                              dt, seed=10 + i,
                                              shuffle=shuffle)
        elem = 2 if dt == torch.bfloat16 else 4
        bms, by = paged_bound(B, H, K, hd, elem, lens)
        lib = f"{lms:.4f} ms" if lms is not None else "n/a"
        print(f"[kernels] paged B{B} H{H} K{K} hd{hd} page{page} "
              f"s_max{s_max} {str(dt)[6:]} shuffled={shuffle} "
              f"tokens={int(lens.sum())}: max_abs_err {err:.3g} kernel "
              f"{kms:.4f} ms plain {pms:.4f} ms sdpa {lib} bound "
              f"{bms:.4f} ms ({by})")
        if i == 0:
            rows["paged_attention"] = dict(max_abs_err=err, ms=kms,
                                           plain_ms=pms, library_ms=lms,
                                           bound_ms=bms, bound_by=by)
    return rows


def phase_parity() -> None:
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


def phase_serve(fa, pa) -> dict:
    """llama2-13b, full width and depth, bf16, EWSJF, on the card."""
    import torch
    from repro_torch.launch.serve import card_engine_config, card_requests
    from repro_torch.serving.api import serve
    reqs = card_requests()       # 24 at t=0: 19 short, 5 long
    ecfg = card_engine_config()
    torch.cuda.reset_peak_memory_stats()
    fa.KERNEL.launches = 0
    pa.KERNEL.launches = 0
    t0 = time.monotonic()
    out = serve("llama2-13b", reqs, smoke=False, scheduler="ewsjf",
                engine_config=ecfg, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"flash_attention": fa.KERNEL.launches,
                "paged_attention": pa.KERNEL.launches}
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
    for name, n in launches.items():
        check(n > 0, f"{name} launched on the main path")
    short = [r.ttft for r in fin if r.prompt_len <= 128]
    long_ = [r.ttft for r in fin if r.prompt_len > 128]
    print(f"[serve] llama2-13b 40 layers d5120 bf16 EWSJF: {len(fin)} "
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

    t_start = time.monotonic()
    phase_setup(kbuild)
    rows = phase_kernels(fa, pa)
    phase_parity()
    torch.cuda.empty_cache()
    launches = phase_serve(fa, pa)
    sources = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention/kernel.py:88"),
               "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention/kernel.py:75")}
    kernels = []
    for name, (source, replaces) in sources.items():
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(f"[summary] all phases passed in {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
