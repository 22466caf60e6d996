"""Time the bf16 flash cases of ``chip_smoke.py`` on one card, each held
element by element against its tiled plain version.

    PYTHONPATH=src python -m repro_torch.launch.flash_bench \\
        [--seeds N] [--iters N] [--no-time] [--cases main,hubert,...]

Builds ``csrc/flash_attention.cu`` (its ``-Xptxas -v`` lines printed:
registers, shared memory, spills), then, for each case, draws q, k and v
from a seed on the card (rows of k and v at and past ``kv_len`` NaN, which
must never be read) and holds the kernel's output against
``ref.py::flash_attention_tiled_ref`` at ``ops.BF16_KV_TILE`` (|d| <= 1e-3 +
1e-2·|ref|) and against the dense ``flash_attention_ref`` (3e-2), for every
seed.  Unless ``--no-time``, it then times the kernel and
``torch.nn.functional.scaled_dot_product_attention`` (a yardstick the port
never calls) by CUDA events around one CUDA-graph replay of ``--iters``
calls, beside the bound (``ops.flash_counts`` over 989 TFLOP/s and 3.35
TB/s), and the host µs of one call's tensor-map encodes where the kernel
has them.  Prints one line a case, then one JSON object of every case;
exits 1 if any check failed.

It imports only ``repro_torch.kernels``, so it times whichever tree is
first on ``PYTHONPATH``: two trees are compared in one call on one card by
running this file with each in turn (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

BF16_PEAK_FLOPS = 989e12     # H100 SXM data sheet, dense bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
TILED_ATOL, TILED_RTOL = 1e-3, 1e-2   # as chip_smoke.py's bf16 flash checks
DENSE_TOL = 3e-2

# name: B, S, H, K, dk, dv, causal, window, q_offset, T (None: S); the
# shapes of chip_smoke.py's bf16 flash cases, by the suffix of their rows.
CASES = {
    "main": (2, 1024, 40, 40, 128, 128, True, 0, 0, None),
    "offset": (1, 512, 40, 40, 128, 128, True, 0, 1024, 2048),
    "mla": (2, 1024, 16, 16, 192, 128, True, 0, 0, None),
    "cpm": (2, 1024, 40, 40, 96, 64, True, 0, 0, None),
    "cpm_offset": (1, 512, 40, 40, 96, 64, True, 0, 1024, 2048),
    "danube": (2, 1024, 32, 8, 80, 80, True, 4096, 0, None),
    "gemma3_local": (2, 2048, 8, 4, 256, 256, True, 1024, 0, None),
    "gemma3_global": (2, 2048, 8, 4, 256, 256, True, 0, 0, None),
    "rg": (2, 2048, 16, 1, 256, 256, True, 2048, 0, None),
    "phi35": (2, 1024, 32, 8, 128, 128, True, 0, 0, None),
    "hubert": (8, 1024, 16, 16, 80, 80, False, 0, 0, None),
    "internvl2": (2, 1024, 64, 8, 128, 128, True, 0, 0, None),
    "s2048": (2, 2048, 40, 40, 128, 128, True, 0, 0, None),
    "window256": (1, 1024, 40, 40, 128, 128, True, 256, 0, None),
    "s128": (8, 128, 40, 40, 128, 128, True, 0, 0, None),
    "chunk1": (1, 1, 40, 40, 128, 128, True, 0, 1500, 2048),
    "chunk200": (1, 200, 40, 40, 128, 128, True, 0, 1500, 2048),
    "chunk300_window": (1, 300, 40, 40, 128, 128, True, 256, 700, 2048),
    "mla_s128": (8, 128, 16, 16, 192, 128, True, 0, 0, None),
    "mla_s2048": (2, 2048, 16, 16, 192, 128, True, 0, 0, None),
}


def time_ms(fn, iters: int) -> float:
    """Device ms of one call: CUDA events around one replay of a CUDA graph
    of ``iters`` calls (``chip_smoke.py::time_ms``'s graph timer)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run_case(fa, name, spec, seeds, timed, iters) -> dict:
    """One case: the checks on every seed, then (``timed``) the times."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_tiled_ref)
    B, S, H, K, dk, dv, causal, window, off, T = spec
    T = S if T is None else T
    kv_len = off + S if off else T
    kw = dict(causal=causal, window=window, q_offset=off, kv_len=kv_len)
    row = dict(case=name, shape=spec, tile=fa.BF16_KV_TILE[dk], ok=True)
    worst_t, worst_d = 0.0, 0.0
    for seed in range(seeds):
        g = torch.Generator(device="cuda")
        g.manual_seed(1000 + seed)
        q = torch.randn((B, S, H, dk), generator=g, device="cuda").bfloat16()
        k = torch.randn((B, T, K, dk), generator=g, device="cuda").bfloat16()
        v = torch.randn((B, T, K, dv), generator=g, device="cuda").bfloat16()
        k[:, kv_len:] = float("nan")
        v[:, kv_len:] = float("nan")
        out = fa.flash_attention(q, k, v, **kw).float()
        torch.cuda.synchronize()
        ref = flash_attention_tiled_ref(
            *(t.transpose(1, 2) for t in (q, k, v)), **kw,
            tile=fa.BF16_KV_TILE[dk]).transpose(1, 2).float()
        dense = fa.flash_attention(q, k, v, impl="plain", **kw).float()
        finite = bool(torch.isfinite(out).all())
        worst_t = max(worst_t, float(((out - ref).abs() / (
            TILED_ATOL + TILED_RTOL * ref.abs())).max()))
        worst_d = max(worst_d, float((out - dense).abs().max()))
        row["ok"] &= finite and worst_t <= 1.0 and worst_d <= DENSE_TOL
    row.update(worst_vs_tiled=worst_t, max_abs_err=worst_d)
    if not timed:
        return row
    kms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), iters)
    qt = q.transpose(1, 2)
    kt, vt = (t[:, :kv_len].transpose(1, 2) for t in (k, v))
    mask = None
    if window or off or kv_len != S:
        pos = off + torch.arange(S, device="cuda")[:, None]
        kpos = torch.arange(kv_len, device="cuda")[None]
        mask = kpos <= pos if causal else torch.ones_like(kpos <= pos)
        if window:
            mask &= kpos > pos - window
    lms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=H != K), iters)
    flops, nbytes = fa.flash_counts(B, S, H, K, dk, 2, causal, window, off,
                                    kv_len, dv)
    t_ops, t_bytes = flops / BF16_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    row.update(ms=kms, sdpa_ms=lms, bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    if hasattr(fa, "map_encode_us"):
        row["map_encode_us"] = fa.map_encode_us(q, k, v)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--cases", default=",".join(CASES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bench needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False, timeout=60)
    print(f"card: {smi.stdout.strip()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; tree {_build.CSRC.parent}")
    for line in _build.build(["flash_attention"]).get(
            "flash_attention", "").splitlines():
        if ("built in" in line or "error" in line.lower()
                or "spill" in line or "Used" in line
                or "Compiling entry" in line or "arning" in line):
            print(f"[build] {line.strip()}")
    rows, failed = [], []
    for name in args.cases.split(","):
        row = run_case(fa, name, CASES[name], args.seeds, not args.no_time,
                       args.iters)
        rows.append(row)
        times = ""
        if "ms" in row:
            times = (f" kernel {row['ms']:.4f} ms sdpa {row['sdpa_ms']:.4f}"
                     f" ms bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
                     f" kernel/sdpa {row['ms'] / row['sdpa_ms']:.2f} share of"
                     f" bound {row['bound_ms'] / row['ms']:.2f}")
            if "map_encode_us" in row:
                times += f" encode {row['map_encode_us']:.2f} us"
        print(f"[flash] {name} {row['shape']} tile {row['tile']}: "
              f"{'ok' if row['ok'] else 'FAILED'} worst vs tiled "
              f"{row['worst_vs_tiled']:.3g} vs dense "
              f"{row['max_abs_err']:.3g}{times}", flush=True)
        if not row["ok"]:
            failed.append(name)
    print(json.dumps({"flash_bench": rows}))
    if failed:
        print(f"FAILED: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
