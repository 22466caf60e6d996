#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. setup: print the card's name and power limit, build the three CUDA
   kernels from ``src/repro_torch/csrc`` (one ``nvcc`` each, in parallel);
2. kernels: hold flash attention (bf16 as wgmma products fed by TMA, f32
   as three TF32 products on the tensor cores; the host µs of a bf16 call's
   tensor-map encodes printed), paged attention (split sequences,
   then merge) and the SSD
   chunk kernel against their plain PyTorch versions on the card at the
   main paths' shapes (the llama2 prefill buckets from B=8 S=128 to B=2
   S=2048; 8 decode slots of 2048 tokens, one long among short ones
   included) and, for flash, the chunked-prefill shapes (queries at an
   offset into a 2048-position slot cache whose rows past the visible keys
   hold NaN, which must never be read); flash is also held element by
   element against ``flash_attention_tiled_ref`` rounding as each kernel
   does (bf16: P in bf16; f32: three TF32 products of split operands, with
   the 3xTF32 bound printed beside the CUDA-core f32 one), MLA paged
   attention and grouped paged attention (G >= 2) against
   ``paged_attention_tiled_ref`` (bf16: P in bf16; f32: three TF32 products
   of split operands, its bytes, 3xTF32 and CUDA-core bounds printed) and
   the SSD main case against
   ``ssd_chunk_tiled_ref`` (bf16: P′ and w∘x in bf16; f32: three TF32
   products of split operands, with the 3xTF32 bound printed beside the
   CUDA-core f32 one), each of which rounds what its kernel rounds.
   Times kernel (graph and eager timers), plain version, the least time the
   card could take (bound) and, for attention,
   ``torch.nn.functional.scaled_dot_product_attention`` (a yardstick only:
   the port never calls it; no single PyTorch call computes SSD); both
   attention kernels also at deepseek-v2-lite's MLA shapes (prefill in MHA
   form with keys of 192 and values of 128, H = K = 16; absorbed decode over
   8 slots of 2048 latent rows, keys of 576 and values the view of their
   first 512 columns, one KV head and 16 query heads; its bf16 and f32
   main cases also at each partition size of ``MLA_PARTITIONS_TRIED``) and
   at minicpm3-4b's (prefill in MHA form with keys of 96 and values of 64,
   H = K = 40, also as a 512-token chunk at offset 1024; absorbed decode
   with keys of 288, values the view of their first 256 columns, G = 40 in
   three head tiles), at h2o-danube-1.8b's (flash (80, 80), B=2, S=1024,
   H=32, K=8, window 4096; paged hd 80, G = 4, over 8 slots of 2048) and
   at gemma3-4b's (flash (256, 256), B=2, S=2048, H=8, K=4, window 1024
   and global; paged hd 256, G = 2, over 8 slots of 2048 and over 8
   wrapped rings of 1024, a local layer's ring as pages), at
   recurrentgemma-9b's (flash (256, 256), B=2, S=2048, H=16, K=1, window
   2048; paged hd 256 at G = 16 in one M tile, over 8 slots of 2048 and
   over 8 full rings of 2048; a NaN in one query head stays in that
   head), at phi3.5-moe's
   (flash at H=32, K=8, hd 128 in f32 beside the bf16 GQA case; paged hd
   128, G = 4, bf16 and f32, over 8 slots of 2048 at random lengths and
   with one long slot among short ones), at hubert-xlarge's (flash (80,
   80) bidirectional, B=8, S=1024, H = K = 16, bf16 and f32, timed beside
   SDPA without a mask; S=1000 and S=1 for error only) and at
   internvl2-76b's (flash (128, 128) causal at B=2, S=1024, H=64, K=8;
   paged hd 128, G = 8, over 8 slots of 2048 at random lengths and with
   one long slot among short ones; bf16 and f32); the grouped paged
   cases (``GQA_CASES``, bf16 on ``paged_gqa_mma_kernel``, f32 on
   ``paged_gqa_tf32x3_kernel``) also at each partition size of
   ``GQA_PARTITIONS_TRIED``; and, for an MLA
   chunk in MHA form, the time of the decompression of the latent rows
   beside the flash call it feeds;
3. parity: llama2-13b and mamba2-370m at full width and 2 layers, in f32 —
   one prefill and a few greedy decode steps through the kernels and
   through the plain versions must give the same tokens and close logits,
   and llama2's prompt fed through ``chunk_step`` in chunks of 512, 512 and
   the rest must give the prefill's tokens and logits (each parity phase
   counts its f32 flash or SSD launches);
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
   - mesh (a): on a one-rank NCCL (1, 1) mesh, the weights distributed
     under the serve policy, one prefill and 8 greedy decode steps over
     caches whose sequence is placed over "model" (each rank's paged
     partials, merged) must give the plain call's greedy tokens;
   then, with llama2-13b's weights freed, deepseek-v2-lite-16b: a
   full-width 2-layer f32 parity (the dense head block and one MoE block)
   of the card's kernels against the CPU's plain versions, whose greedy
   tokens may part only at a measured router or logit near-tie, and
   ``chunk_step`` over a prompt in three chunks (MoE dense) with equal
   tokens on card and CPU and the card's one prefill; the full-width bf16
   serve of the same 24 requests under EWSJF (MLA prefill through flash,
   absorbed decode through paged attention, MoE experts by capacity
   dispatch), with peak device memory under 75 GiB; then with the same
   weights the chunked+radix serve of the shared-prefix traffic (MLA
   chunks through flash at a query offset, the latent rows as the host KV
   blocks), held as llama2's; mesh (b): its MoE layers through ``ep_a2a``
   on the one-rank mesh must give ``dropping``'s tokens and logits there;
   then minicpm3-4b: the same 2-layer f32
   parities (no MoE), its full-width, full-depth (62 layers) bf16 serve
   of the 24 requests and, with the same weights, its chunked+radix
   serve; then the sliding-window families in f32 on the card, kernels
   against plain versions: h2o-danube-1.8b at 2 layers with rings of the
   published 4096 slots (s_max 4608), a 4090-token prompt and 16 greedy
   steps across the window, and gemma3-4b at one period (5 local layers
   of window 1024, 1 global) with a 1100- and a 60-token prompt in one
   bucket of 2048, whose tokens must also equal each prompt's alone; then
   both at full width and depth in bf16, bucketed, under EWSJF (at s_max
   2048 h2o-danube's rings are whole slots: its window is inert there);
   then recurrentgemma-9b in f32 at full width and 5 layers (one period of
   rglru, rglru, local and a tail of 2 RG-LRU layers; a 2040- and a
   300-token prompt in one batch, a ring of 2048 wrapped by 16 greedy
   steps; equal to each prompt alone) and its 38-layer bf16 serve, every
   flash launch windowed; then phi3.5-moe-42b-a6.6b: a 2-layer f32 parity
   and its bf16 serve at 16 of 32 layers (``launch/serve.py::
   CARD_DEPTH_CUTS``: the whole model is ~84 GB in bf16); then qwen3-4b: a
   2-layer f32 parity, its 36-layer bf16 serve and, with the same weights,
   its chunked+radix serve; then hubert-xlarge: a 2-layer f32 parity of
   per-position logits (bidirectional flash at (80, 80) against the plain
   versions on the card) and its 48-layer bf16 forward over 8 clips of
   1024 frames (finite logits of (8, 1024, 504), ms a batch, frames/s);
   then internvl2-76b: a 2-layer f32 parity prefilled with embeddings
   (the prompt tokens' table rows) and 16 greedy steps, and its bf16 serve
   at 24 of 80 layers (the whole model is ~141 GB in bf16), its own peak
   under 60 GiB.  Each serve prints its peak device memory and, beside it,
   its own peak above what was allocated before it;
5. train, with every serve's weights freed (no kernel of the repository
   runs on this path): (a) each kernel wrapper refuses, on the card, an
   input that requires grad under autograd, and so do the prefill mixers
   ``ssm_forward`` and ``mla_forward`` (their ``train=True`` forms run);
   (b) at full width in f32, one ``train_loss`` backward and 3 AdamW
   steps on the card against the CPU from the same weights (loss within
   1e-5 relative, every gradient leaf within 1e-4 of its scale, the
   steps' losses within 1e-4; an MoE model's router choices recorded on
   both sides): llama2-13b at 1 layer, mamba2-370m at 2 (S 384: a whole
   chunk and a padded one), recurrentgemma-9b at 3 (one period: two
   RG-LRU layers and a local one), deepseek-v2-lite-16b at 2 (the dense
   head layer and one MoE layer) and minicpm3-4b at 2 (``TRAIN_PARITY``);
   (c) ``blockwise_gqa_attend`` against the dense ``reference_attend`` at
   B 1, S 4096, H = K = 40, hd 128, f32, causal (output within 2e-5,
   gradients within 1e-4 of scale); (d) ``launch/train.py::main`` at full
   width, bf16 compute, remat (``TRAIN_RUNS``): llama2-13b cut to 8 of 40
   layers (``TRAIN_DEPTH_CUTS``), batch 2 x 4096 (every layer blockwise),
   20 steps; mamba2-370m whole, batch 8 x 4096, 20 steps;
   recurrentgemma-9b cut to 8 of 38 (two periods and the 2-layer RG-LRU
   tail), batch 2 x 4096 (local layers blockwise over their window), 20
   steps; deepseek-v2-lite-16b cut to 5 of 27, batch 2 x 4096 (MLA folded
   into MHA form through blockwise), 20 steps: finite losses and gradient
   norms, the loss falling, each run's own peak under 60 GiB; ms a step,
   tokens/s and the model-FLOPs share of the bf16 peak printed
   (``launch/op_count.py::train_flops``, llama2's figure held to its
   closed form); (e)
   checkpoint/restart of the smoke config on the card (4 straight steps
   against 2, a checkpoint, a restore and 2), bitwise under deterministic
   algorithms or within 1e-6 of scale, whichever held printed; then mesh
   (c): llama2's training cut counted on meta (``launch/op_count.py``)
   within 1% of ``llama2_train_flops``, its roofline terms and (d)'s
   measured step over the larger;
6. summary: one call of each kernel's bf16 main case (and of the f32
   flash main, offset and MLA cases, the f32 MLA paged case, the f32
   SSD main case and every minicpm3-4b case) under
   ``torch.profiler`` names the device kernels that ran,
   with their device time (the ``variant`` of its entry); a line of the replaced designs' times as recorded in
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
from contextlib import contextmanager
from functools import partial
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BF16_PEAK_FLOPS = 989e12     # H100 SXM data sheet, dense bf16 tensor cores
F32_PEAK_FLOPS = 67e12       # H100 SXM data sheet, f32 outside tensor cores
TF32_PEAK_FLOPS = 494.7e12   # H100 SXM data sheet, dense TF32 tensor cores
# The f32 flash kernel takes each multiply as three TF32 products.
TF32X3_PEAK_FLOPS = TF32_PEAK_FLOPS / 3
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
F32_TOL, BF16_TOL = 1e-4, 3e-2   # kernel vs plain: summation order differs
# bf16 flash vs its tiled plain version, per element: |d| <= atol + rtol·|ref|.
# Both round the same P and the same output to bf16 (an ulp is at most 2^-7
# of the value); what is left is f32 summation order.
TILED_ATOL, TILED_RTOL = 1e-3, 1e-2
# f32 flash vs its 3xTF32 plain version (flash_attention_tiled_ref with
# tf32_products=3), per element: |d| <= atol + rtol·|ref|.  Both split the
# same operands into TF32 big + small and drop the same small·small terms,
# so the split's own error (below 2^-21 of each operand) cancels; what is
# left is f32 accumulation order (about dk·2^-24 of Σ|q·k| in a score, the
# tensor cores' adds included) and ex2.approx's 2 ulp.  Never looser than
# F32_TOL.
TF32X3_ATOL, TF32X3_RTOL = 1e-5, 1e-4
# bf16 SSD vs ssd_chunk_tiled_ref, per element: |d| <= atol · max|ref| +
# rtol·|ref|.  Both round the same P′ and w∘x to bf16; what is left is f32
# summation order, exp2 and the decay scan's order, which can also move a
# rounded operand by one bf16 ulp (2^-8 of it).
SSD_TILED_ATOL, SSD_TILED_RTOL = 1e-3, 1e-2
# f32 SSD vs its 3xTF32 plain version (ssd_chunk_tiled_ref with
# tf32_products=3), per element: |d| <= atol · max|ref| + rtol·|ref|.  Both
# split the same operands into TF32 big + small and take the decays from an
# f64 scan rounded once to f32; what is left is f32 accumulation order
# (about 2^-24·√K of the summed magnitudes over K <= 256 terms, well under
# 5e-6 of the scale) and ex2.approx's 2 ulp.  atol + rtol is a quarter of
# F32_TOL.
SSD_TF32X3_ATOL, SSD_TF32X3_RTOL = 5e-6, 2e-5
# The llama2 serve's decode shape at its worst: one long slot among short ones.
LONG_AMONG_SHORT = [2000, 17, 99, 1, 64, 33, 80, 5]
# Tokens a partition of the MLA paged kernels: each size is timed on the
# bf16 and f32 main cases, and ops.py's MLA_PARTITION is the faster
# (PERF.md section 6).
MLA_PARTITIONS_TRIED = (64, 128)
# The grouped paged decode cases of the kernel phase, each run in bf16
# (``paged_gqa_mma_kernel``) and f32 (``paged_gqa_tf32x3_kernel``; see
# ``grouped_kernel``), by row name:
# query heads, KV heads, head dim, rows of a slot (or of a ring, whose
# seq_lens are all full), lengths (None: random) and seed; B = 8, pages of
# 16.  h2o-danube-1.8b, gemma3-4b (global slots and local rings),
# recurrentgemma-9b (slots and rings), phi3.5-moe and internvl2-76b.
GQA_CASES = {
    "paged_attention_danube": (32, 8, 80, 2048, LONG_AMONG_SHORT, 110),
    "paged_attention_gemma3": (8, 4, 256, 2048, LONG_AMONG_SHORT, 111),
    "paged_attention_gemma3_ring": (8, 4, 256, 1024, [1024] * 8, 112),
    "paged_attention_rg": (16, 1, 256, 2048, LONG_AMONG_SHORT, 130),
    "paged_attention_rg_ring": (16, 1, 256, 2048, [2048] * 8, 131),
    "paged_attention_phi35": (32, 8, 128, 2048, None, 160),
    "paged_attention_phi35_long": (32, 8, 128, 2048, LONG_AMONG_SHORT, 161),
    # seed 10 draws llama2's main paged lengths: 9,198 tokens
    "paged_attention_internvl2": (64, 8, 128, 2048, None, 10),
    "paged_attention_internvl2_long": (64, 8, 128, 2048, LONG_AMONG_SHORT,
                                       171),
}
# Tokens a partition of the grouped kernels: the bf16 cases below and every
# f32 case of ``GQA_CASES`` are timed at each size, and ops.py's
# GQA_PARTITION is the fastest summed over each type's (PERF.md section 6).
GQA_PARTITIONS_TRIED = (64, 128, 256)
GQA_PARTITION_CASES = ("paged_attention_rg", "paged_attention_rg_ring",
                       "paged_attention_danube", "paged_attention_gemma3",
                       "paged_attention_phi35_long")
# Profiler sessions tried for one call in ``launched_kernels``: CUPTI on
# the card's machine now and then records no device event, sometimes in
# two sessions in a row.
PROFILER_SESSIONS = 6
# Main-case times of the designs the kernels replaced, as PERF.md section 6
# records them, by the timer each was taken with (NVIDIA H100 80GB HBM3 at
# 700 W): the bf16 flash cases' mma.sync kernel (flash_fwd_mma_kernel, FA2's
# shape, replaced by the wgmma kernel) by the graph timer of the trees that
# added each case (main, offset, MLA, minicpm3, h2o-danube, gemma3 (32-key
# tiles), recurrentgemma, phi3.5, hubert, internvl2); paged attention's by
# the eager timer of the chip_smoke.py that added the SSD kernel; the
# CUDA-core bf16 SSD kernel's 0.9817 ms by
# that eager timer and 0.9765 ms by the graph timer of the chip_smoke.py
# that redesigned attention; the CUDA-core bf16 MLA paged kernel's by both
# timers of the first call of the chip_smoke.py that added it, the f32 one's
# by the graph timer (the lowest recorded, 0.0606-0.0627); the f32
# flash cases' CUDA-core kernel by the graph timer (the main case on the
# tree that redesigned bf16 SSD, the MLA case on the one that added
# deepseek, the offset case the lowest of the calls of the one that added
# the query offset, which read 0.769-0.780); the CUDA-core f32 SSD kernel's
# by the graph timer (the tree that redesigned f32 flash); the grouped paged cases
# on the CUDA-core split kernel (G = 16 as two head tiles of 8) by the graph
# timer, bf16 of the tree that added each (h2o-danube-1.8b and gemma3-4b;
# recurrentgemma-9b and phi3.5-moe), f32 the lowest PERF.md records (the
# trees that added each; internvl2-76b's and qwen3-4b's).  Printed on a
# line of their own,
# labelled as recorded, each beside this run's time by the same timer, never
# in the kernels line.
RECORDED_EARLIER_MS = {"flash_attention": {"graph": 0.1053},
                       "flash_attention_offset": {"graph": 0.0744},
                       "flash_attention_mla": {"graph": 0.0696},
                       "flash_attention_cpm": {"graph": 0.0882},
                       "flash_attention_cpm_offset": {"graph": 0.0597},
                       "flash_attention_danube": {"graph": 0.0749},
                       "flash_attention_gemma3_local": {"graph": 0.1510},
                       "flash_attention_gemma3_global": {"graph": 0.2069},
                       "flash_attention_rg": {"graph": 0.3430},
                       "flash_attention_phi35": {"graph": 0.0908},
                       "flash_attention_hubert": {"graph": 0.2133},
                       "flash_attention_internvl2": {"graph": 0.1572},
                       "paged_attention": {"eager": 0.3273},
                       "ssd_chunk": {"eager": 0.9817, "graph": 0.9765},
                       "paged_attention_mla": {"graph": 0.0503,
                                               "eager": 0.0627},
                       "paged_attention_mla_f32": {"graph": 0.0606},
                       "flash_attention_f32": {"graph": 1.0365},
                       "flash_attention_mla_f32": {"graph": 0.9554},
                       "flash_attention_offset_f32": {"graph": 0.769},
                       "ssd_chunk_f32": {"graph": 0.9642},
                       "paged_attention_rg": {"graph": 0.0689},
                       "paged_attention_rg_ring": {"graph": 0.0719},
                       "paged_attention_danube": {"graph": 0.0259},
                       "paged_attention_gemma3": {"graph": 0.0285},
                       "paged_attention_gemma3_ring": {"graph": 0.0239},
                       "paged_attention_phi35": {"graph": 0.0232},
                       "paged_attention_phi35_long": {"graph": 0.0253},
                       "paged_attention_danube_f32": {"graph": 0.0368},
                       "paged_attention_gemma3_f32": {"graph": 0.0288},
                       "paged_attention_gemma3_ring_f32": {"graph": 0.0363},
                       "paged_attention_rg_f32": {"graph": 0.0474},
                       "paged_attention_rg_ring_f32": {"graph": 0.0507},
                       "paged_attention_phi35_f32": {"graph": 0.0385},
                       "paged_attention_phi35_long_f32": {"graph": 0.0365},
                       "paged_attention_internvl2_f32": {"graph": 0.0905},
                       "paged_attention_internvl2_long_f32": {
                           "graph": 0.0490}}


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


def launched_kernels(fn) -> dict:
    """The device kernels one call of ``fn`` ran, as ``torch.profiler``
    names them (namespace, return type and arguments dropped), each with
    its device time in µs, sorted by name.  A session that records no
    device event at all is repeated after a pause that doubles from 0.5 s,
    up to ``PROFILER_SESSIONS`` in all; what a session does record is
    returned as it is."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile
    # Keep CUPTI initialized from one session to the next: with its
    # teardown after each session, some later sessions on the card
    # recorded no device event at all (PyTorch turns teardown off for the
    # same reason when it profiles CUDA graphs).
    os.environ["TEARDOWN_CUPTI"] = "0"
    device_us = {}
    for attempt in range(PROFILER_SESSIONS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if (ev.device_type == torch.autograd.DeviceType.CUDA
                    and ev.self_device_time_total > 0):
                name = ev.key.replace("(anonymous namespace)::", "")
                name = name.removeprefix("void ").split("(")[0]
                device_us[name] = (device_us.get(name, 0.0)
                                   + ev.self_device_time_total)
        if device_us or attempt == PROFILER_SESSIONS - 1:
            break
        print(f"[variants] profiler session {attempt + 1} recorded no "
              f"device event; profiling the call again")
        time.sleep(0.5 * 2 ** attempt)
    return dict(sorted(device_us.items()))


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
        print(f"[setup]   {name}: {log.splitlines()[0]}")
        for kernel, regs, spill in ptxas_usage(log):
            print(f"[setup]   {name}: {kernel}: {regs} registers, {spill} "
                  f"bytes spill stores")


def ptxas_usage(log: str) -> list:
    """(kernel<template ints>, registers, spill-store bytes) of every entry
    function in an ``nvcc -Xptxas -v`` log, in its order."""
    import re
    out, kernel, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            base = mangled      # the length-prefixed name ending in _kernel
            for i in range(len(mangled)):
                d = re.match(r"\d+", mangled[i:])
                name = mangled[i + len(d.group()):][:int(d.group())] if d else ""
                if name.endswith("_kernel"):
                    base = name
            args = re.findall(r"Li(\d+)E", mangled)
            kernel = f"{base}<{', '.join(args)}>"
            spill = 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and kernel:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out.append((kernel, int(m.group(1)), spill))
            kernel = None
    return out


def flash_case(fa, B, S, H, K, hd, dtype, causal, window, seed, q_offset=0,
               T=None, kv_len=None, hd_v=None, scale=None, timed=True):
    """One flash-attention comparison: S queries at ``q_offset`` against the
    first ``kv_len`` keys (default all) of (B, T, K, hd) keys and (B, T, K,
    hd_v) values (T defaults to S, hd_v to hd); rows past ``kv_len`` hold
    NaN, which must never be read.  Returns (max_abs_err, worst |d| / (atol
    + rtol·|ref|) against the tiled plain version that rounds as the kernel
    does (bf16: P in bf16; f32: three TF32 products), kernel_ms, eager
    kernel_ms, plain_ms, library_ms, the kernel call); without ``timed``
    the four times are None (checked for error only)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_tiled_ref)
    T = S if T is None else T
    kv_len = T if kv_len is None else kv_len
    hd_v = hd if hd_v is None else hd_v
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q = torch.randn((B, S, H, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, T, K, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, T, K, hd_v), generator=g, device="cuda").to(dtype)
    k[:, kv_len:] = float("nan")
    v[:, kv_len:] = float("nan")
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len,
              scale=scale)
    what = (f"flash {dtype} B{B} S{S} H{H} K{K} hd{hd}/{hd_v} w{window} "
            f"q_offset{q_offset} kv_len{kv_len}")
    out = fa.flash_attention(q, k, v, **kw)
    ref = fa.flash_attention(q, k, v, impl="plain", **kw)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    check(bool(torch.isfinite(out.float()).all()), f"{what} output finite")
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    check(err <= tol, f"{what} err {err:.3g} <= {tol}")
    if dtype == torch.bfloat16:
        atol, rtol = TILED_ATOL, TILED_RTOL
        rounding = dict(tile=fa.BF16_KV_TILE[hd])
    else:
        atol, rtol = TF32X3_ATOL, TF32X3_RTOL
        rounding = dict(round_p=False, tf32_products=3,
                        tile=fa.F32_KV_TILE[hd])
    ref_t = flash_attention_tiled_ref(
        *(t.transpose(1, 2) for t in (q, k, v)), **kw,
        **rounding).transpose(1, 2).float()
    tiled = float(((out.float() - ref_t).abs()
                   / (atol + rtol * ref_t.abs())).max())
    check(tiled <= 1.0, f"{what} within {atol} + {rtol}·|ref| of the tiled "
                        f"plain version (worst {tiled:.3g})")

    def call():
        return fa.flash_attention(q, k, v, **kw)
    if not timed:
        return err, tiled, None, None, None, None, call
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
        enable_gqa=H != K, scale=scale))
    return err, tiled, kms, ems, pms, lms, call


def flash_bound(B, S, H, K, hd, elem, causal, window, peak, q_offset=0,
                kv_len=None, hd_v=None):
    """Least time (ms) for the work, and what bounds it: the FLOPs and
    bytes of ``kernels/flash_attention/ops.py::flash_counts`` (the matmul
    FLOPs over the visible pairs, q and out and the visible k and v moved
    once) over ``peak`` and the HBM rate."""
    from repro_torch.kernels.flash_attention.ops import flash_counts
    flops, nbytes = flash_counts(B, S, H, K, hd, elem, causal, window,
                                 q_offset, kv_len, hd_v)
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def flash_bounds(dtype, B, S, H, K, hd, causal, window, **kw) -> tuple:
    """``flash_bound`` at the peak of the kernel's products (bf16 tensor
    cores; f32 as three TF32 products) and, for f32, also at the CUDA
    cores' f32 peak: (ms, bound_by, CUDA-core ms or None)."""
    import torch
    if dtype == torch.bfloat16:
        return (*flash_bound(B, S, H, K, hd, 2, causal, window,
                             BF16_PEAK_FLOPS, **kw), None)
    bms, by = flash_bound(B, S, H, K, hd, 4, causal, window,
                          TF32X3_PEAK_FLOPS, **kw)
    cms, _ = flash_bound(B, S, H, K, hd, 4, causal, window, F32_PEAK_FLOPS,
                         **kw)
    return bms, by, cms


def flash_notes(dtype, tiled, bms, by, cms) -> tuple:
    """The printed comparison with the tiled plain version and the
    bound(s) of one flash case."""
    import torch
    if dtype == torch.bfloat16:
        vs = f" worst |d| / ({TILED_ATOL} + {TILED_RTOL}·|tiled|) {tiled:.3g}"
        return vs, f"bound {bms:.4f} ms ({by})"
    vs = (f" worst |d| / ({TF32X3_ATOL} + {TF32X3_RTOL}·|3xTF32 plain|) "
          f"{tiled:.3g}")
    return vs, (f"3xTF32 bound {bms:.4f} ms ({by}; CUDA-core f32 bound "
                f"{cms:.4f} ms)")


def flash_row(err, tiled, kms, ems, pms, lms, bms, by, cms, case) -> dict:
    """One flash case's entry: this run's numbers, and for f32 the CUDA-core
    bound and the worst ratio against the 3xTF32 plain version."""
    row = dict(max_abs_err=err, ms=kms, eager_ms=ems, plain_ms=pms,
               library_ms=lms, bound_ms=bms, bound_by=by, case=case)
    if cms is not None:
        row.update(bound_cuda_core_ms=cms, worst_vs_tf32x3=tiled)
    return row


def flash_family_case(fa, rows: dict, calls: dict, name: str, label: str,
                      B, S, H, K, hd, dtype, causal, window, seed) -> None:
    """One timed flash case at a model family's widths (``flash_case``),
    printed with its bound and SDPA, its row and call added under
    ``name``."""
    err, tiled, kms, ems, pms, lms, call = flash_case(
        fa, B, S, H, K, hd, dtype, causal, window, seed=seed)
    bms, by, cms = flash_bounds(dtype, B, S, H, K, hd, causal, window)
    vs_tiled, bound = flash_notes(dtype, tiled, bms, by, cms)
    kind = "causal" if causal else "bidirectional"
    mask = ""
    if window:
        kind, mask = f"{kind}, window {window}", " (boolean mask)"
    print(f"[kernels] flash {label} B{B} S{S} H{H} K{K} hd{hd} "
          f"{str(dtype)[6:]} {kind}: max_abs_err {err:.3g}{vs_tiled} kernel "
          f"{kms:.4f} ms (eager timer {ems:.4f} ms) plain {pms:.4f} ms "
          f"sdpa{mask} {lms:.4f} ms {bound}; kernel / sdpa {kms / lms:.2f} "
          f"(graph timer both)")
    rows[name] = flash_row(err, tiled, kms, ems, pms, lms, bms, by, cms,
                           f"B={B}, S=T={S}, H={H}, K={K}, hd={hd}, {kind}, "
                           f"{str(dtype)[6:]}")
    calls[name] = call


def paged_case(pa, B, H, K, hd, page, s_max, dtype, seed, shuffle,
               lens=None, hd_v=None, scale=None):
    """One paged-attention comparison over a slot cache viewed as pages,
    at ``lens`` or at random lengths; with ``hd_v`` (MLA) the values are
    the view of the key rows' first hd_v columns.  The tensor-core kernels
    (MLA; G >= 2) are also held per element against
    ``paged_attention_tiled_ref`` rounding as each does (bf16: P in bf16;
    f32: three TF32 products), over their own partitions.  Returns (err,
    worst |d| / (atol + rtol·|ref|) against the tiled plain version (MLA
    and grouped; else None), kernel_ms, eager kernel_ms, plain_ms,
    library_ms, seq_lens, the kernel call)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_tiled_ref)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    pages = s_max // page
    kc = torch.randn((B, s_max, K, hd), generator=g, device="cuda").to(dtype)
    if hd_v is None:
        vc = torch.randn((B, s_max, K, hd), generator=g,
                         device="cuda").to(dtype)
    else:
        vc = kc[..., :hd_v]
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
    vp = (vc.view(B * pages, page, K, hd) if hd_v is None
          else kp[..., :hd_v])
    out = pa.paged_attention(q, kp, vp, table, seq_lens, scale=scale)
    ref = pa.paged_attention(q, kp, vp, table, seq_lens, scale=scale,
                             impl="plain")
    torch.cuda.synchronize()
    err = max_err(out, ref)
    check(bool(torch.isfinite(out.float()).all()), "paged output finite")
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    check(err <= tol, f"paged {dtype} hd{hd}/{hd_v or hd} shuffle={shuffle} "
                      f"err {err:.3g} <= {tol}")
    tiled = None
    bf16 = dtype == torch.bfloat16
    if hd_v is not None or H > K:
        atol, rtol = (TILED_ATOL, TILED_RTOL) if bf16 else (TF32X3_ATOL,
                                                             TF32X3_RTOL)
        ref_t = paged_attention_tiled_ref(
            q, kp, vp, table, seq_lens,
            partition=pa.partition_for(hd, hd_v or hd, H // K, dtype),
            scale=scale, round_p=bf16,
            tf32_products=0 if bf16 else 3).float()
        tiled = float(((out.float() - ref_t).abs()
                       / (atol + rtol * ref_t.abs())).max())
        check(tiled <= 1.0, f"paged {dtype} hd{hd}/{hd_v or hd} G{H // K} "
                            f"shuffle={shuffle} within {atol} + "
                            f"{rtol}·|ref| of the tiled plain version "
                            f"(worst {tiled:.3g})")

    def call():
        return pa.paged_attention(q, kp, vp, table, seq_lens, scale=scale)
    kms = time_ms(call)
    ems = time_ms(call, graph=False)
    pms = time_ms(lambda: pa.paged_attention(q, kp, vp, table, seq_lens,
                                             scale=scale, impl="plain"),
                  iters=5, warmup=1)
    lms = None
    if not shuffle:     # identity table: the pool is the contiguous cache
        mask = (torch.arange(s_max, device="cuda")[None]
                < seq_lens[:, None])[:, None, None, :]
        qt = q[:, :, None, :]
        kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
        lms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=H != K, scale=scale))
    return err, tiled, kms, ems, pms, lms, lens, call


def paged_bound(B, H, K, hd, elem, lens, hd_v=None, peak=BF16_PEAK_FLOPS):
    """Least time (ms): the bytes over HBM bandwidth against the FLOPs over
    ``peak`` (:func:`paged_terms`), and which of the two bounds it."""
    t_bytes, flops = paged_terms(B, H, K, hd, elem, lens, hd_v)
    t_ops = flops / peak * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def paged_terms(B, H, K, hd, elem, lens, hd_v=None) -> tuple:
    """``kernels/paged_attention/ops.py::paged_counts``' bytes over HBM
    bandwidth (ms), and its FLOPs."""
    from repro_torch.kernels.paged_attention.ops import paged_counts
    flops, nbytes = paged_counts(B, H, K, hd, elem, lens, hd_v)
    return nbytes / HBM_BYTES_PER_S * 1e3, flops


def grouped_kernel(hd: int, group: int, dtype) -> str:
    """The split kernel ``paged_attention`` runs at head dim ``hd`` with
    ``group`` query heads a KV head, as ``launch_group`` in
    csrc/paged_attention.cu routes it."""
    import torch
    if group == 1:
        return "paged_split_kernel"
    if dtype == torch.bfloat16:
        return "paged_gqa_mma_kernel"
    return "paged_gqa_tf32x3_kernel"


def gqa_case(pa, name: str, dtype) -> tuple:
    """One grouped paged case of ``GQA_CASES`` in ``dtype``, against its
    plain versions (``paged_case``), printed with its bound (f32: the
    bytes, 3xTF32 and CUDA-core terms beside it and the split kernel's
    recorded time), SDPA and the worst ratio against the tiled plain
    version.  Returns its row and the kernel call."""
    import torch
    H, K, hd, s_max, lens, seed = GQA_CASES[name]
    B, page = 8, 16
    err, tiled, kms, ems, pms, lms, lens_, call = paged_case(
        pa, B, H, K, hd, page, s_max, dtype, seed=seed, shuffle=False,
        lens=lens)
    bf16 = dtype == torch.bfloat16
    partition = pa.partition_for(hd, hd, H // K, dtype)
    n_split = -(-s_max // partition)
    bms, by = paged_bound(B, H, K, hd, 2 if bf16 else 4, lens_,
                          peak=BF16_PEAK_FLOPS if bf16 else TF32X3_PEAK_FLOPS)
    kernel = grouped_kernel(hd, H // K, dtype)
    atol, rtol = (TILED_ATOL, TILED_RTOL) if bf16 else (TF32X3_ATOL,
                                                        TF32X3_RTOL)
    bound = f"bound {bms:.4f} ms ({by})"
    row = dict(max_abs_err=err, worst_vs_tiled=tiled, partition=partition,
               kernel=kernel, ms=kms, eager_ms=ems, plain_ms=pms,
               library_ms=lms, bound_ms=bms, bound_by=by)
    if not bf16:
        t_bytes, flops = paged_terms(B, H, K, hd, 4, lens_)
        row.update(bound_bytes_ms=t_bytes,
                   bound_tf32x3_ms=flops / TF32X3_PEAK_FLOPS * 1e3,
                   bound_cuda_core_ms=flops / F32_PEAK_FLOPS * 1e3)
        earlier = RECORDED_EARLIER_MS[name + "_f32"]["graph"]
        bound = (f"bound {bms:.4f} ms ({by}; bytes {t_bytes:.4f}, 3xTF32 "
                 f"{row['bound_tf32x3_ms']:.4f}, CUDA-core "
                 f"{row['bound_cuda_core_ms']:.4f}); paged_split_kernel "
                 f"recorded {earlier:.4f} ms (PERF.md, graph timer)")
    ring = s_max == lens_.min() == lens_.max()
    print(f"[kernels] paged {name[16:]} B{B} H{H} K{K} hd{hd} (G = "
          f"{H // K}: {kernel}, one M tile of 16 rows) page{page} "
          f"{'rings' if ring else 'slots'} of {s_max} {str(dtype)[6:]} "
          f"lens={lens_.tolist()} tokens={int(lens_.sum())} ({n_split} "
          f"partitions of {partition} tokens): max_abs_err {err:.3g} worst "
          f"|d| / ({atol} + {rtol}·|tiled|) {tiled:.3g} kernel {kms:.4f} ms "
          f"(eager timer {ems:.4f} ms) plain {pms:.4f} ms sdpa {lms:.4f} ms "
          f"{bound}; kernel / sdpa {kms / lms:.2f} (graph timer both)")
    row["case"] = (f"B={B} {'rings' if ring else 'slots'} of {s_max}, "
                   f"lens={lens_.tolist()}, H={H}, K={K}, hd={hd}, page "
                   f"{page}, {str(dtype)[6:]}")
    return row, call


def phase_gqa_partitions(pa, rows: dict) -> None:
    """The bf16 grouped cases of ``GQA_PARTITION_CASES`` and every f32 case
    of ``GQA_CASES``, checked and timed again at each other partition size
    of ``GQA_PARTITIONS_TRIED`` (then the size restored); each row gains
    its ms by partition, and each type's sums over its cases are
    printed."""
    import torch
    chosen = pa.GQA_PARTITION
    for dtype, names, sfx in ((torch.bfloat16, GQA_PARTITION_CASES, ""),
                              (torch.float32, tuple(GQA_CASES), "_f32")):
        sums = dict.fromkeys(GQA_PARTITIONS_TRIED, 0.0)
        for name in names:
            by_partition = {}
            for partition in GQA_PARTITIONS_TRIED:
                if partition == chosen:
                    by_partition[partition] = rows[name + sfx]["ms"]
                    continue
                pa.GQA_PARTITION = partition
                try:
                    row, _ = gqa_case(pa, name, dtype)
                finally:
                    pa.GQA_PARTITION = chosen
                by_partition[partition] = row["ms"]
            for partition, ms in by_partition.items():
                sums[partition] += ms
            print(f"[kernels] paged GQA {str(dtype)[6:]} {name[16:]} ms by "
                  f"partition (graph timer) {by_partition}; GQA_PARTITION "
                  f"is {chosen}")
            rows[name + sfx]["ms_by_partition"] = by_partition
        print(f"[kernels] paged GQA {str(dtype)[6:]} ms summed over its "
              f"{len(names)} cases by partition (graph timer) "
              + json.dumps({p: round(ms, 4) for p, ms in sums.items()})
              + f"; GQA_PARTITION is {chosen}")


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
    tiled plain version that rounds as the kernels do (bf16: P′ and w∘x in
    bf16; f32: three TF32 products), kernel_ms, eager kernel_ms, plain_ms,
    the kernel call)."""
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
    if dtype == torch.bfloat16:
        atol, rtol, rounding = SSD_TILED_ATOL, SSD_TILED_RTOL, {}
    else:
        atol, rtol = SSD_TF32X3_ATOL, SSD_TF32X3_RTOL
        rounding = dict(round=False, tf32_products=3)
    tiled = max(float(((o - r).abs() / (atol * r.abs().max()
                                        + rtol * r.abs())).max())
                for o, r in zip(out, ssd_chunk_tiled_ref(*args, **rounding)))
    check(tiled <= 1.0, f"ssd_chunk {dtype} b{b} S{S} Q{Q} within "
                        f"{atol}·max|ref| + {rtol}·|ref| of the tiled plain "
                        f"version (worst {tiled:.3g})")

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
    """Least time (ms) of one ssd_chunk call, and what bounds it:
    ``kernels/ssd_scan/ops.py::ssd_counts``' FLOPs over ``peak`` and bytes
    over the HBM rate."""
    from repro_torch.kernels.ssd_scan.ops import ssd_counts
    flops, nbytes = ssd_counts(b, S, H, P, G, N, Q, elem)
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_ssd_kernel(so, rows: dict, calls: dict) -> None:
    """The SSD chunk kernels against their plain versions at mamba2-370m's
    shapes (b=4, S=2048 and 1024, H=32, P=64, N=128, G=1, Q=256), then the
    whole scan at a ragged S and an S below one chunk.  Adds the bf16 and
    f32 main cases' rows and kernel calls to ``rows`` and ``calls``."""
    import torch
    b, H, P, G, N, Q = 4, 32, 64, 1, 128, 256
    # the main case in both types, then the S = 1000 prefill as the kernel
    # sees it (padded to 4 chunks)
    for i, (S, dt) in enumerate(((2048, torch.bfloat16),
                                 (2048, torch.float32),
                                 (1024, torch.bfloat16))):
        aerr, err, tiled, kms, ems, pms, fn = ssd_chunk_case(
            so, b, S, H, P, G, N, Q, dt, seed=20 + i)
        if dt == torch.bfloat16:
            bms, by = ssd_bound(b, S, H, P, G, N, Q, 2, BF16_PEAK_FLOPS)
            cms = None
            vs = f"{SSD_TILED_ATOL}·max|tiled| + {SSD_TILED_RTOL}·|tiled|"
            bound = f"bound {bms:.4f} ms ({by})"
        else:
            bms, by = ssd_bound(b, S, H, P, G, N, Q, 4, TF32X3_PEAK_FLOPS)
            cms, _ = ssd_bound(b, S, H, P, G, N, Q, 4, F32_PEAK_FLOPS)
            vs = (f"{SSD_TF32X3_ATOL}·max|3xTF32 plain| + {SSD_TF32X3_RTOL}"
                  f"·|3xTF32 plain|")
            bound = (f"3xTF32 bound {bms:.4f} ms ({by}; CUDA-core f32 bound "
                     f"{cms:.4f} ms)")
        print(f"[kernels] ssd_chunk b{b} S{S} H{H} P{P} G{G} N{N} Q{Q} "
              f"{str(dt)[6:]} (B, C read per group): max_abs_err {aerr:.3g} "
              f"max_rel_err {err:.3g} worst |d| / ({vs}) {tiled:.3g} "
              f"kernel {kms:.4f} ms (eager timer {ems:.4f} ms) plain "
              f"{pms:.4f} ms library n/a (no single PyTorch call computes "
              f"SSD) {bound}")
        name = {0: "ssd_chunk", 1: "ssd_chunk_f32"}.get(i)
        if name:
            rows[name] = dict(max_abs_err=aerr, ms=kms, eager_ms=ems,
                              plain_ms=pms, library_ms=None, bound_ms=bms,
                              bound_by=by,
                              case=f"b={b}, S={S}, H={H}, P={P}, G={G}, "
                                   f"N={N}, Q={Q}, {str(dt)[6:]}")
            if cms is not None:
                rows[name].update(bound_cuda_core_ms=cms,
                                  worst_vs_tf32x3=tiled)
            calls[name] = fn
    for i, (S_, dt) in enumerate(((1000, torch.float32),
                                  (1000, torch.bfloat16),
                                  (200, torch.float32))):
        ey, eh = ssd_scan_case(so, b, S_, H, P, G, N, Q, dt, seed=30 + i)
        padded = -(-S_ // Q) * Q if S_ > Q else S_
        print(f"[kernels] ssd scan b{b} S{S_} chunk {Q} {str(dt)[6:]} "
              f"(kernel Q {min(Q, S_)}, padded to {padded}): rel err y "
              f"{ey:.3g} final state {eh:.3g}")


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
        (2, 1024, 32, 8, 128, torch.bfloat16, True, 0),     # GQA (phi3.5)
        (1, 1024, 40, 40, 128, torch.bfloat16, True, 256),  # window
        (2, 1000, 40, 40, 128, torch.float32, True, 0),     # ragged S
        (8, 128, 40, 40, 128, torch.bfloat16, True, 0),     # short bucket
        (2, 2048, 40, 40, 128, torch.bfloat16, True, 0),    # longest bucket
    ]
    for i, (B, S, H, K, hd, dt, causal, window) in enumerate(cases):
        err, tiled, kms, ems, pms, lms, call = flash_case(
            fa, B, S, H, K, hd, dt, causal, window, seed=i)
        bms, by, cms = flash_bounds(dt, B, S, H, K, hd, causal, window)
        vs_tiled, bound = flash_notes(dt, tiled, bms, by, cms)
        print(f"[kernels] flash B{B} S{S} H{H} K{K} hd{hd} {str(dt)[6:]} "
              f"causal={causal} window={window}: max_abs_err {err:.3g}"
              f"{vs_tiled} kernel {kms:.4f} ms (eager timer {ems:.4f} ms) "
              f"plain {pms:.4f} ms sdpa {lms:.4f} ms {bound}; kernel / sdpa "
              f"{kms / lms:.2f} (graph timer both)")
        name = {0: "flash_attention", 1: "flash_attention_f32",
                2: "flash_attention_phi35"}.get(i)
        if name:
            rows[name] = flash_row(
                err, tiled, kms, ems, pms, lms, bms, by, cms,
                f"B={B}, S=T={S}, H={H}, K={K}, hd={hd}, causal, "
                f"{str(dt)[6:]}")
            calls[name] = call
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
        bms, by, cms = flash_bounds(dt, 1, C, H, K, hd, True, window,
                                    q_offset=off, kv_len=kv_len)
        vs_tiled, bound = flash_notes(dt, tiled, bms, by, cms)
        print(f"[kernels] flash offset B1 C{C} q_offset{off} kv_len{kv_len} "
              f"T{T} H{H} K{K} hd{hd} {str(dt)[6:]} window={window}: "
              f"max_abs_err {err:.3g}{vs_tiled} kernel {kms:.4f} ms (eager "
              f"timer {ems:.4f} ms) plain {pms:.4f} ms sdpa (boolean mask) "
              f"{lms:.4f} ms {bound}; kernel / sdpa {kms / lms:.2f} (graph "
              f"timer both)")
        name = {0: "flash_attention_offset",
                1: "flash_attention_offset_f32"}.get(i)
        if name:
            rows[name] = flash_row(
                err, tiled, kms, ems, pms, lms, bms, by, cms,
                f"B=1, C={C}, q_offset={off}, kv_len={kv_len}, T={T}, "
                f"H=K={H}, hd={hd}, causal, {str(dt)[6:]}")
            calls[name] = call
    # The host's share of a bf16 call: encoding its six TMA tensor maps.
    q = torch.empty((2, 1024, 40, 128), dtype=torch.bfloat16, device="cuda")
    enc = fa.map_encode_us(q, q, q)
    print(f"[kernels] flash bf16 tensor-map encode at the main case: "
          f"{enc:.3f} µs a call (six maps, mean of 1000; host clock)")
    rows["flash_attention"]["map_encode_us"] = enc
    pcases = [(torch.bfloat16, False, None), (torch.float32, False, None),
              (torch.bfloat16, True, None), (torch.float32, True, None),
              (torch.bfloat16, False, LONG_AMONG_SHORT),
              (torch.float32, False, LONG_AMONG_SHORT)]
    B, H, K, hd, page, s_max = 8, 40, 40, 128, 16, 2048
    n_split = pa.split_count(s_max // page, page)
    for i, (dt, shuffle, lens) in enumerate(pcases):
        err, _, kms, ems, pms, lms, lens, call = paged_case(
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
    phase_kernels_mla(fa, pa, rows, calls)
    return rows, calls


def phase_kernels_mla(fa, pa, rows: dict, calls: dict) -> None:
    """Both attention kernels at deepseek-v2-lite's MLA shapes, against
    their plain versions: prefill folded into MHA form (H = K = 16, q/k of
    128 + 64 rope = 192, v of 128, scale 192^-0.5) at the serve's buckets,
    and absorbed decode over 8 slots of 2048 latent rows (one KV head of
    576 = 512 + 64, values the view of the rows' first 512 columns, G =
    16).  Adds the main cases' rows and calls under ``*_mla``."""
    import torch
    H, dk, dv, scale = 16, 192, 128, 192 ** -0.5
    cases = [  # B, S, dtype
        (2, 1024, torch.bfloat16),      # main MLA prefill case
        (2, 1024, torch.float32),
        (8, 128, torch.bfloat16),       # short bucket
        (2, 2048, torch.bfloat16),      # longest bucket
        (2, 1000, torch.float32),       # ragged S
    ]
    for i, (B, S, dt) in enumerate(cases):
        err, tiled, kms, ems, pms, lms, call = flash_case(
            fa, B, S, H, H, dk, dt, True, 0, seed=60 + i, hd_v=dv,
            scale=scale)
        bms, by, cms = flash_bounds(dt, B, S, H, H, dk, True, 0, hd_v=dv)
        vs_tiled, bound = flash_notes(dt, tiled, bms, by, cms)
        print(f"[kernels] flash MLA B{B} S{S} H=K={H} dk{dk} dv{dv} "
              f"{str(dt)[6:]} causal: max_abs_err {err:.3g}{vs_tiled} kernel "
              f"{kms:.4f} ms (eager timer {ems:.4f} ms) plain {pms:.4f} ms "
              f"sdpa {lms:.4f} ms {bound}; kernel / sdpa {kms / lms:.2f} "
              f"(graph timer both)")
        name = {0: "flash_attention_mla", 1: "flash_attention_mla_f32"}.get(i)
        if name:
            rows[name] = flash_row(
                err, tiled, kms, ems, pms, lms, bms, by, cms,
                f"B={B}, S={S}, H=K={H}, dk={dk}, dv={dv}, causal, scale "
                f"192^-0.5, {str(dt)[6:]}")
            calls[name] = call
    dk, dv = pa.MLA_DIMS
    B, K, page, s_max = 8, 1, 16, 2048
    n_split = pa.mla_split_count(s_max // page, page)
    pcases = [(torch.bfloat16, False, None), (torch.float32, False, None),
              (torch.bfloat16, True, None),
              (torch.bfloat16, False, LONG_AMONG_SHORT),
              (torch.float32, False, LONG_AMONG_SHORT)]
    for i, (dt, shuffle, lens) in enumerate(pcases):
        err, tiled, kms, ems, pms, lms, lens, call = paged_case(
            pa, B, H, K, dk, page, s_max, dt, seed=70 + i, shuffle=shuffle,
            lens=lens, hd_v=dv, scale=scale)
        row = paged_mla_row(dt, B, H, K, dk, dv, lens, err, tiled, kms, ems,
                            pms, lms)
        lib = f"{lms:.4f} ms" if lms is not None else "n/a"
        ratio = (f"; kernel / sdpa {kms / lms:.2f} (graph timer both)"
                 if lms is not None else "")
        atol, rtol = ((TILED_ATOL, TILED_RTOL) if dt == torch.bfloat16
                      else (TF32X3_ATOL, TF32X3_RTOL))
        bounds = (f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
                  if dt == torch.bfloat16 else
                  f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; bytes "
                  f"{row['bound_bytes_ms']:.4f}, 3xTF32 "
                  f"{row['bound_tf32x3_ms']:.4f}, CUDA-core "
                  f"{row['bound_cuda_core_ms']:.4f})")
        print(f"[kernels] paged MLA B{B} H{H} K{K} dk{dk} dv{dv} (values a "
              f"view of the key rows) page{page} s_max{s_max} {str(dt)[6:]} "
              f"shuffled={shuffle} lens={lens.tolist()} tokens="
              f"{int(lens.sum())} ({n_split} partitions of "
              f"{pa.MLA_PARTITION} tokens): max_abs_err {err:.3g} worst |d| "
              f"/ ({atol} + {rtol}·|tiled|) {tiled:.3g} kernel {kms:.4f} ms "
              f"(eager timer {ems:.4f} ms) plain {pms:.4f} ms sdpa {lib} "
              f"{bounds}{ratio}")
        name = {0: "paged_attention_mla", 1: "paged_attention_mla_f32"}.get(i)
        if name:
            rows[name] = dict(
                row, case=f"B={B} slots of {s_max}, lens={lens.tolist()}, "
                          f"H={H}, K={K}, dk={dk}, dv={dv} (a view of the key "
                          f"rows), page {page}, scale 192^-0.5, "
                          f"{str(dt)[6:]}")
            calls[name] = call
    # MLA_PARTITION is the faster of the sizes tried: each main case is
    # checked and timed again at each other one, then the size restored.
    chosen = pa.MLA_PARTITION
    for name, dt, seed in (("paged_attention_mla", torch.bfloat16, 70),
                           ("paged_attention_mla_f32", torch.float32, 71)):
        by_partition = {}
        for partition in MLA_PARTITIONS_TRIED:
            if partition == chosen:
                by_partition[partition] = rows[name]["ms"]
                continue
            pa.MLA_PARTITION = partition
            n_parts = pa.mla_split_count(s_max // page, page)
            try:
                err, tiled, kms, ems, *_ = paged_case(
                    pa, B, H, K, dk, page, s_max, dt, seed=seed,
                    shuffle=False, hd_v=dv, scale=scale)
            finally:
                pa.MLA_PARTITION = chosen
            by_partition[partition] = kms
            print(f"[kernels] paged MLA {str(dt)[6:]} main case, {n_parts} "
                  f"partitions of {partition} tokens: max_abs_err {err:.3g} "
                  f"worst |d| / (atol + rtol·|tiled|) {tiled:.3g} kernel "
                  f"{kms:.4f} ms (eager timer {ems:.4f} ms)")
        print(f"[kernels] paged MLA {str(dt)[6:]} main case ms by partition "
              f"(graph timer) {by_partition}; MLA_PARTITION is {chosen}")
        rows[name]["ms_by_partition"] = by_partition


def phase_kernels_minicpm3(fa, pa, rows: dict, calls: dict) -> None:
    """Both attention kernels at minicpm3-4b's MLA shapes, against their
    plain versions: prefill folded into MHA form (H = K = 40, q/k of 64 +
    32 rope = 96, v of 64, scale 96^-0.5) at the serve's main bucket and
    as a 512-token chunk at offset 1024 of a 2048-row cache (rows past the
    visible keys NaN), and absorbed decode over 8 slots of 2048 latent rows
    (one KV head of 288 = 256 + 32, values the view of the rows' first 256
    columns, G = 40: three 16-row head tiles).  Each in bf16 and f32; adds
    the rows and calls under ``*_cpm``."""
    import torch
    H, dk, dv, scale = 40, 96, 64, 96 ** -0.5
    fcases = [  # name, B, S, q_offset, T, dtype
        ("flash_attention_cpm", 2, 1024, 0, None, torch.bfloat16),
        ("flash_attention_cpm_f32", 2, 1024, 0, None, torch.float32),
        ("flash_attention_cpm_offset", 1, 512, 1024, 2048, torch.bfloat16),
        ("flash_attention_cpm_offset_f32", 1, 512, 1024, 2048,
         torch.float32),
    ]
    for i, (name, B, S, off, T, dt) in enumerate(fcases):
        kv_len = off + S
        err, tiled, kms, ems, pms, lms, call = flash_case(
            fa, B, S, H, H, dk, dt, True, 0, seed=80 + i, q_offset=off, T=T,
            kv_len=kv_len, hd_v=dv, scale=scale)
        bms, by, cms = flash_bounds(dt, B, S, H, H, dk, True, 0, hd_v=dv,
                                    q_offset=off, kv_len=kv_len)
        vs_tiled, bound = flash_notes(dt, tiled, bms, by, cms)
        print(f"[kernels] flash minicpm3 B{B} S{S} q_offset{off} kv_len"
              f"{kv_len} T{T or S} H=K={H} dk{dk} dv{dv} {str(dt)[6:]} "
              f"causal: max_abs_err {err:.3g}{vs_tiled} kernel {kms:.4f} ms "
              f"(eager timer {ems:.4f} ms) plain {pms:.4f} ms sdpa "
              f"{lms:.4f} ms {bound}; kernel / sdpa {kms / lms:.2f} (graph "
              f"timer both)")
        rows[name] = flash_row(
            err, tiled, kms, ems, pms, lms, bms, by, cms,
            f"B={B}, S={S}, q_offset={off}, kv_len={kv_len}, T={T or S}, "
            f"H=K={H}, dk={dk}, dv={dv}, causal, scale 96^-0.5, "
            f"{str(dt)[6:]}")
        calls[name] = call
    dk, dv = 288, 256
    B, K, page, s_max = 8, 1, 16, 2048
    n_split = pa.mla_split_count(s_max // page, page)
    pcases = [("paged_attention_cpm", torch.bfloat16, None),
              ("paged_attention_cpm_f32", torch.float32, None),
              (None, torch.bfloat16, LONG_AMONG_SHORT),
              (None, torch.float32, LONG_AMONG_SHORT)]
    for i, (name, dt, lens) in enumerate(pcases):
        err, tiled, kms, ems, pms, lms, lens, call = paged_case(
            pa, B, H, K, dk, page, s_max, dt, seed=90 + i % 2, shuffle=False,
            lens=lens, hd_v=dv, scale=scale)
        row = paged_mla_row(dt, B, H, K, dk, dv, lens, err, tiled, kms, ems,
                            pms, lms)
        atol, rtol = ((TILED_ATOL, TILED_RTOL) if dt == torch.bfloat16
                      else (TF32X3_ATOL, TF32X3_RTOL))
        print(f"[kernels] paged MLA minicpm3 B{B} H{H} K{K} dk{dk} dv{dv} "
              f"(values a view of the key rows; {-(-H // 16)} head tiles) "
              f"page{page} s_max{s_max} {str(dt)[6:]} lens={lens.tolist()} "
              f"tokens={int(lens.sum())} ({n_split} partitions of "
              f"{pa.MLA_PARTITION} tokens): max_abs_err {err:.3g} worst |d| "
              f"/ ({atol} + {rtol}·|tiled|) {tiled:.3g} kernel {kms:.4f} ms "
              f"(eager timer {ems:.4f} ms) plain {pms:.4f} ms sdpa "
              f"{lms:.4f} ms bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}); kernel / sdpa {kms / lms:.2f} (graph "
              f"timer both)")
        if name:
            rows[name] = dict(
                row, case=f"B={B} slots of {s_max}, lens={lens.tolist()}, "
                          f"H={H}, K={K}, dk={dk}, dv={dv} (a view of the key "
                          f"rows), page {page}, scale 96^-0.5, "
                          f"{str(dt)[6:]}")
            calls[name] = call


def phase_kernels_ring(fa, pa, rows: dict, calls: dict) -> None:
    """Both attention kernels at the sliding-window families' widths,
    against their plain versions, each in bf16 and f32: flash at
    h2o-danube-1.8b's (80, 80) (B=2, S=1024, H=32, K=8, window 4096) and
    gemma3-4b's (256, 256) (B=2, S=2048, H=8, K=4, local window 1024 and
    global), and paged decode at hd 80 with G = 4 and hd 256 with G = 2 over
    8 slots of 2048 tokens (one long slot among short ones), and at hd 256
    over 8 wrapped rings of 1024 slots (``seq_lens`` 1024: a local layer's
    ring as pages).  Adds the rows and calls under ``*_danube``,
    ``*_gemma3_local``, ``*_gemma3_global`` and ``*_gemma3_ring``."""
    import torch
    fcases = [  # name, B, S, H, K, hd, window
        ("flash_attention_danube", 2, 1024, 32, 8, 80, 4096),
        ("flash_attention_gemma3_local", 2, 2048, 8, 4, 256, 1024),
        ("flash_attention_gemma3_global", 2, 2048, 8, 4, 256, 0),
    ]
    for i, (name, B, S, H, K, hd, window) in enumerate(fcases):
        for dt, sfx in ((torch.bfloat16, ""), (torch.float32, "_f32")):
            flash_family_case(fa, rows, calls, name + sfx, name[16:], B, S, H,
                              K, hd, dt, True, window, seed=100 + i)
    for name in ("paged_attention_danube", "paged_attention_gemma3",
                 "paged_attention_gemma3_ring"):
        for dt, sfx in ((torch.bfloat16, ""), (torch.float32, "_f32")):
            rows[name + sfx], calls[name + sfx] = gqa_case(pa, name, dt)


def phase_kernels_phi35(fa, pa, rows: dict, calls: dict) -> None:
    """Both attention kernels at phi3.5-moe's GQA widths (32 query heads on
    8 KV heads, hd 128, G = 4), against their plain versions: flash in f32
    at B=2, S=1024 (the bf16 case is ``phase_kernels``' GQA case), and paged
    decode in bf16 and f32 over 8 slots of 2048 tokens at random lengths and
    with one long slot among short ones.  Adds the rows and calls under
    ``*_phi35`` and ``paged_attention_phi35_long``."""
    import torch
    flash_family_case(fa, rows, calls, "flash_attention_phi35_f32", "phi3.5",
                      2, 1024, 32, 8, 128, torch.float32, True, 0, seed=150)
    for name in ("paged_attention_phi35", "paged_attention_phi35_long"):
        for dt, sfx in ((torch.bfloat16, ""), (torch.float32, "_f32")):
            rows[name + sfx], calls[name + sfx] = gqa_case(pa, name, dt)


def phase_kernels_recurrentgemma(fa, pa, rows: dict, calls: dict) -> None:
    """Both attention kernels at recurrentgemma-9b's widths (MQA: 16 query
    heads on 1 KV head, hd 256), against their plain versions, each in bf16
    and f32: flash (256, 256) at B=2, S=2048, window 2048 (its local layers'
    prefill), and paged decode at G = 16 (one M tile of 16 rows in either
    type) over 8 slots of 2048 tokens with one 2000-token slot among short
    ones, and over 8 full rings of 2048 (``seq_lens`` 2048: a local layer's
    ring as pages); then a NaN in one query head (of either half of the M
    tile) must stay in that head.  Adds the rows and calls under ``*_rg``
    and ``paged_attention_rg_ring``."""
    import torch
    hd = 256
    for dt, sfx in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        flash_family_case(fa, rows, calls, "flash_attention_rg" + sfx,
                          "recurrentgemma", 2, 2048, 16, 1, hd, dt, True,
                          2048, seed=120)
    for name in ("paged_attention_rg", "paged_attention_rg_ring"):
        for dt, sfx in ((torch.bfloat16, ""), (torch.float32, "_f32")):
            rows[name + sfx], calls[name + sfx] = gqa_case(pa, name, dt)
    page = 16
    g = torch.Generator(device="cuda")
    g.manual_seed(140)
    lens = torch.tensor([5, 300, 2000], dtype=torch.int32, device="cuda")
    table = torch.arange(3 * 128, dtype=torch.int32,
                         device="cuda").reshape(3, 128)
    for dt in (torch.bfloat16, torch.float32):
        kp, vp = (torch.randn((3 * 128, page, 1, hd), generator=g,
                              device="cuda").to(dt) for _ in range(2))
        for head in (3, 12):                  # rows grp and grp + 8 of the M tile
            q = torch.randn((3, 16, hd), generator=g, device="cuda").to(dt)
            q[1, head, 7] = float("nan")
            out = pa.paged_attention(q, kp, vp, table, lens)
            want = torch.zeros((3, 16), dtype=torch.bool, device="cuda")
            want[1, head] = True
            check(torch.equal(out.isnan().all(-1), want)
                  and not bool(out[~want].isnan().any()),
                  f"paged G = 16 {dt}: a NaN in query head {head} stays in "
                  f"that head")
    print("[kernels] paged G = 16 bf16 and f32 (one M tile each): a NaN in "
          "query head 3 or 12 reaches that head alone")


def phase_kernels_encoder(fa, rows: dict, calls: dict) -> None:
    """Flash attention at hubert-xlarge's widths (H = K = 16, (80, 80)),
    bidirectional (``causal=False``: every query tile walks every key tile,
    and only the visible-key test masks the keys past S in the last tile),
    against its plain version in bf16 and f32: B=8, S=1024 (the main case,
    timed beside SDPA without a mask and the bound), then S=1000 and S=1
    (one key) for error only.  Adds the rows and calls under
    ``flash_attention_hubert``."""
    import torch
    B, H, K, hd = 8, 16, 16, 80
    for dt, sfx in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        flash_family_case(fa, rows, calls, "flash_attention_hubert" + sfx,
                          "hubert", B, 1024, H, K, hd, dt, False, 0, seed=180)
        for S in (1000, 1):
            err, tiled, *_ = flash_case(fa, B, S, H, K, hd, dt, False, 0,
                                        seed=181 + S, timed=False)
            print(f"[kernels] flash hubert B{B} S{S} H{H} K{K} hd{hd} "
                  f"{str(dt)[6:]} bidirectional: max_abs_err {err:.3g}"
                  f"{flash_notes(dt, tiled, 0.0, '', 0.0)[0]} (error only)")


def phase_kernels_internvl2(fa, pa, rows: dict, calls: dict) -> None:
    """Both attention kernels at internvl2-76b's GQA widths (64 query heads
    on 8 KV heads, hd 128, G = 8), against their plain versions, each in
    bf16 and f32: flash causal at B=2, S=1024 (its prefill), and paged
    decode over 8 slots of 2048 tokens at random lengths (llama2's 9,198
    tokens) and with one long slot among short ones (bf16 on
    ``paged_gqa_mma_kernel``, f32 on ``paged_gqa_tf32x3_kernel``, each held
    per element against the tiled plain version).  Adds the rows and calls
    under ``*_internvl2`` and ``paged_attention_internvl2_long``."""
    import torch
    for dt, sfx in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        flash_family_case(fa, rows, calls, "flash_attention_internvl2" + sfx,
                          "internvl2", 2, 1024, 64, 8, 128, dt, True, 0,
                          seed=170)
    for name in ("paged_attention_internvl2", "paged_attention_internvl2_long"):
        for dt, sfx in ((torch.bfloat16, ""), (torch.float32, "_f32")):
            rows[name + sfx], calls[name + sfx] = gqa_case(pa, name, dt)


def phase_mla_chunk_cost(fa) -> dict:
    """What an MLA chunk costs in MHA form (``models/attention.py::
    mla_chunk_decode``), bf16, one layer, by the graph timer: the
    decompression (the first T latent rows through W_uk and W_uv, keys
    ``[nope ‖ rope]`` assembled), as the function runs it, against the
    flash call over the decompressed keys, for deepseek-v2-lite and
    minicpm3-4b, at the prefix serves' chunks: a whole prompt's 512-token
    chunks at offsets 0 and 512, and a 72-token suffix (the mean of
    ``card_prefix_requests``' 16-128) at offset 1024.  The serve's mix,
    8 whole prompts (both 512-token chunks and a suffix-sized rest) and 16
    attached suffixes, weighs them.  The absorbed route (flash at one KV
    head of r + rd keys) would save the decompression alone, so it pays
    only where that costs more than the attention.  Returns the times by
    model and shape, and the mix's sums."""
    import torch
    shapes = ((512, 0), (512, 512), (72, 1024))
    weights = (8, 8, 8 + 16)            # chunks of each shape in the mix
    out = {}
    for label, H, hd, rd, r, vd in (("deepseek-v2-lite", 16, 128, 64, 512,
                                     128),
                                    ("minicpm3-4b", 40, 64, 32, 256, 64)):
        g = torch.Generator(device="cuda").manual_seed(95)
        bf = dict(generator=g, device="cuda")
        rows = torch.randn((1, 2048, r + rd), **bf).to(torch.bfloat16)
        w_uk = (torch.randn((r, H * hd), **bf) * r ** -0.5).to(torch.bfloat16)
        w_uv = (torch.randn((r, H * vd), **bf) * r ** -0.5).to(torch.bfloat16)
        by_shape = {}
        for C, off in shapes:
            T = off + C
            q = torch.randn((1, C, H, hd + rd), **bf).to(torch.bfloat16)

            def decompress(T=T):
                part = rows[:, :T]
                latent = part[..., :r]
                k_nope = (latent @ w_uk).reshape(1, T, H, hd)
                v = (latent @ w_uv).reshape(1, T, H, vd)
                k = torch.cat([k_nope,
                               part[:, :, None, r:].expand(1, T, H, rd)],
                              dim=-1)
                return k.contiguous(), v.contiguous()
            k, v = decompress()

            def attend(q=q, k=k, v=v, off=off, T=T):
                return fa.flash_attention(q, k, v, causal=True, q_offset=off,
                                          kv_len=T, scale=(hd + rd) ** -0.5)
            dms, ams = time_ms(decompress), time_ms(attend)
            flops = 2.0 * T * r * H * (hd + vd)
            print(f"[kernels] MLA chunk in MHA form, {label}, one layer, "
                  f"bf16, C={C} at offset {off} over T={T} latent rows: "
                  f"decompression {dms:.4f} ms ({flops / 1e9:.2f} GFLOP) "
                  f"against flash ({hd + rd}, {vd}) {ams:.4f} ms (graph "
                  f"timer both)")
            by_shape[f"C={C}@{off}"] = {"decompress_ms": dms,
                                        "flash_ms": ams}
        d_mix = sum(w * t["decompress_ms"]
                    for w, t in zip(weights, by_shape.values()))
        a_mix = sum(w * t["flash_ms"]
                    for w, t in zip(weights, by_shape.values()))
        print(f"[kernels] MLA chunks in MHA form, {label}, the prefix "
              f"serve's mix (8 whole prompts, 16 suffixes), one layer: "
              f"decompression {d_mix:.4f} ms against flash {a_mix:.4f} ms; "
              f"decompression costs more: {d_mix > a_mix}")
        out[label] = {"shapes": by_shape, "mix_decompress_ms": d_mix,
                      "mix_flash_ms": a_mix}
    return out


def paged_mla_row(dt, B, H, K, dk, dv, lens, err, tiled, kms, ems, pms,
                  lms) -> dict:
    """One MLA paged case's numbers: this run's times and errors, and its
    bound at the kernel's own peak (bf16 tensor cores; f32 three TF32
    products a multiply), for f32 with the bytes, 3xTF32 and CUDA-core
    terms beside it."""
    import torch
    elem = 2 if dt == torch.bfloat16 else 4
    peak = BF16_PEAK_FLOPS if dt == torch.bfloat16 else TF32X3_PEAK_FLOPS
    bms, by = paged_bound(B, H, K, dk, elem, lens, hd_v=dv, peak=peak)
    row = dict(max_abs_err=err, worst_vs_tiled=tiled, ms=kms, eager_ms=ems,
               plain_ms=pms, library_ms=lms, bound_ms=bms, bound_by=by)
    if dt == torch.float32:
        t_bytes, flops = paged_terms(B, H, K, dk, elem, lens, hd_v=dv)
        row.update(bound_bytes_ms=t_bytes,
                   bound_tf32x3_ms=flops / TF32X3_PEAK_FLOPS * 1e3,
                   bound_cuda_core_ms=flops / F32_PEAK_FLOPS * 1e3)
    return row


def phase_variants(calls: dict) -> dict:
    """Which device kernels each kernel's main case ran, read from the
    profiler: bf16 flash must run the wgmma kernel alone and f32
    flash the 3xTF32 one alone (main, offset and MLA cases), paged
    attention its split and merge kernels (for groups of 2 or more the
    grouped tensor-core split kernel, bf16 or 3xTF32, ``grouped_kernel``;
    for bf16 MLA the MLA tensor-core one, for f32 MLA the 3xTF32 one;
    llama2's bf16 G = 1 the CUDA-core split kernel), bf16 SSD its two
    tensor-core kernels and f32 SSD its two 3xTF32 ones, and nothing
    else."""
    import torch
    want = {"flash_attention": ("flash_fwd_wgmma_kernel",),
            "flash_attention_offset": ("flash_fwd_wgmma_kernel",),
            "flash_attention_mla": ("flash_fwd_wgmma_kernel",),
            "flash_attention_f32": ("flash_fwd_tf32x3_kernel",),
            "flash_attention_offset_f32": ("flash_fwd_tf32x3_kernel",),
            "flash_attention_mla_f32": ("flash_fwd_tf32x3_kernel",),
            "paged_attention": ("paged_split_kernel", "paged_merge_kernel"),
            "paged_attention_mla": ("paged_mla_mma_kernel",
                                    "paged_merge_kernel"),
            "paged_attention_mla_f32": ("paged_mla_tf32x3_kernel",
                                        "paged_merge_kernel"),
            "flash_attention_cpm": ("flash_fwd_wgmma_kernel",),
            "flash_attention_cpm_f32": ("flash_fwd_tf32x3_kernel",),
            "flash_attention_cpm_offset": ("flash_fwd_wgmma_kernel",),
            "flash_attention_cpm_offset_f32": ("flash_fwd_tf32x3_kernel",),
            "paged_attention_cpm": ("paged_mla_mma_kernel",
                                    "paged_merge_kernel"),
            "paged_attention_cpm_f32": ("paged_mla_tf32x3_kernel",
                                        "paged_merge_kernel"),
            **{f"flash_attention_{case}{sfx}": (kern,)
               for case in ("danube", "gemma3_local", "gemma3_global")
               for sfx, kern in (("", "flash_fwd_wgmma_kernel"),
                                 ("_f32", "flash_fwd_tf32x3_kernel"))},
            **{f"{case}{sfx}": (grouped_kernel(hd, H // K, dt),
                                "paged_merge_kernel")
               for case, (H, K, hd, *_) in GQA_CASES.items()
               for sfx, dt in (("", torch.bfloat16), ("_f32", torch.float32))},
            "flash_attention_rg": ("flash_fwd_wgmma_kernel",),
            "flash_attention_rg_f32": ("flash_fwd_tf32x3_kernel",),
            **{f"flash_attention_{case}{sfx}": (kern,)
               for case in ("phi35", "hubert", "internvl2")
               for sfx, kern in (("", "flash_fwd_wgmma_kernel"),
                                 ("_f32", "flash_fwd_tf32x3_kernel"))},
            "ssd_chunk": ("ssd_chunk_y_mma_kernel",
                          "ssd_chunk_state_mma_kernel"),
            "ssd_chunk_f32": ("ssd_chunk_y_tf32x3_kernel",
                              "ssd_chunk_state_tf32x3_kernel")}
    variants = {}
    for name, call in calls.items():
        device_us = launched_kernels(call)
        ran = list(device_us)
        print(f"[variants] {name} main case ran {ran}; device µs of this "
              f"one profiled call " + ", ".join(
                  f"{k} {us:.2f}" for k, us in device_us.items()))
        check(len(ran) == len(want[name])
              and all(any(w in r for r in ran) for w in want[name]),
              f"{name} main case ran {want[name]}")
        variants[name] = ", ".join(ran)
    return variants


def phase_parity_llama() -> dict:
    """llama2-13b widths at 2 layers, f32: prefill + greedy decode through
    the kernels and through the plain versions.  Returns the f32 flash
    launches of its kernel runs (and of the ``chunk_step`` parity's)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
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
    f0 = fa.KERNEL.launches
    for impl in (None, "plain"):
        if impl == "plain":
            launches = fa.KERNEL.launches - f0
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
    check(launches > 0, "the f32 kernel run launched flash")
    chunks, offset = phase_parity_llama_chunks(cfg, params, pol, rng)
    return {"llama2_parity": launches, "llama2_chunk_parity": chunks,
            "llama2_chunk_parity_offset": offset}


def phase_parity_llama_chunks(cfg, params, pol, rng) -> tuple:
    """One prompt of 1024 + (0..100) tokens, fed through ``chunk_step`` in
    chunks of 512, 512 and the rest (each chunk at its offset, flash with
    a query offset over the slot cache) and through one prefill, both on
    the kernels, then greedy decode steps from each: equal tokens, logits
    within 1e-3.  Returns the f32 flash launches, and those with an offset."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import (chunk_step, decode_step,
                                    init_decode_caches, prefill)
    S = 1024 + int(rng.integers(0, 101))
    widths = [512, 512] + ([S - 1024] if S > 1024 else [])
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (1, S)),
                          device="cuda")
    results = {}
    f0, off0 = fa.KERNEL.launches, fa.KERNEL.offset_launches
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
    return (fa.KERNEL.launches - f0, fa.KERNEL.offset_launches - off0)


def phase_parity_mamba2(so) -> int:
    """mamba2-370m widths at 2 layers, f32: one prefill of rows of
    different lengths (right-padded, with their true lengths) and greedy
    decode steps, through the SSD kernel and through its plain version.
    Returns the f32 SSD launches of its kernel run."""
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
    launches0 = so.KERNEL.launches
    for impl in (None, "plain"):
        logits, caches = prefill(params, {"tokens": tokens}, cfg, policy=pol,
                                 true_lens=true_lens, impl=impl)
        if impl is None:
            launches = so.KERNEL.launches - launches0
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
    check(launches > 0, "the f32 prefill ran the SSD kernel")
    return launches


def phase_parity_deepseek(ops: dict) -> tuple:
    """deepseek-v2-lite at full width and 2 layers (the dense head block and
    one MoE block, 64 experts top-6 plus 2 shared), f32: one prefill of two
    512-token rows and 4 decode steps (row 1 decoding from position 400),
    on the card through the kernels (flash at dk 192 / dv 128, paged at dk
    576 / dv 512) and on the CPU through the plain versions, both fed the
    CPU run's greedy tokens.  The router's choices are recorded on both.
    Greedy tokens must be equal, and logits within 1e-3, except where the
    parting is explained by a measured near-tie: a token whose expert set
    differs must have a CPU gap between its 6th and 7th router
    probabilities within twice the largest router-probability difference
    of the two runs, and a row whose greedy token differs without such a
    flip must hold both tokens within twice the largest logit difference
    of the rows without one.  Returns the card run's f32 flash and f32
    paged (MLA) launches, then ``phase_parity_mla_chunks``'s flash launches
    and those with an offset."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import (DtypePolicy, decode_step,
                                    init_decode_caches, init_params, prefill)
    from repro_torch.models import moe as moe_mod
    cfg = get_config("deepseek-v2-lite-16b").scaled(n_layers=2)
    check(cfg.first_dense_layers == 1 and cfg.n_experts == 64,
          "two layers: the dense head block and one MoE block")
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu", dtype=torch.float32)
    pol = DtypePolicy(torch.float32, torch.float32, torch.float32)
    rng = np.random.default_rng(3)
    B, S, s_max, steps = 2, 512, 1024, 4
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)))
    k = cfg.moe_top_k
    orig_route = moe_mod._route
    runs = {}
    for dev in ("cpu", "cuda"):
        params = cpu_params if dev == "cpu" else cpu_params.to(dev)
        routes = []

        def recording(x2d, router, top_k, _routes=routes):
            gates, idx, probs = orig_route(x2d, router, top_k)
            _routes.append((idx.cpu(), probs.cpu()))
            return gates, idx, probs
        moe_mod._route = recording
        f0 = ops["flash_attention"].KERNEL.launches
        p0 = ops["paged_attention"].KERNEL.launches
        try:
            logits, pc = prefill(params, {"tokens": prompt.to(dev)}, cfg,
                                 policy=pol)
            caches = init_decode_caches(cfg, B, s_max, dtype=torch.float32,
                                        device=dev)
            for dst, src in zip(caches, pc):
                dst["ckv"][:, :S].copy_(src["ckv"])
            pos = np.array([S, 400], dtype=np.int32)
            all_logits = [logits.cpu()]
            feed = (runs["cpu"]["tokens"] if dev == "cuda" else None)
            toks = [logits.argmax(-1).cpu()]
            for step in range(steps):
                tok = (feed[step] if feed is not None else toks[-1])
                logits, caches = decode_step(params, tok.to(dev).to(torch.int32),
                                             caches, pos, cfg, policy=pol)
                all_logits.append(logits.cpu())
                toks.append(logits.argmax(-1).cpu())
                pos = pos + 1
            if dev == "cuda":
                torch.cuda.synchronize()
                f32_flash = ops["flash_attention"].KERNEL.launches - f0
                f32_paged = ops["paged_attention"].KERNEL.launches - p0
                check(ops["flash_attention"].KERNEL.launches > f0
                      and ops["paged_attention"].KERNEL.launches > p0,
                      "deepseek parity ran flash and paged on the card")
        finally:
            moe_mod._route = orig_route
        runs[dev] = {"logits": all_logits, "tokens": toks, "routes": routes}
        del params, caches, pc
    cpu, gpu = runs["cpu"], runs["cuda"]
    check(len(cpu["routes"]) == len(gpu["routes"]) == 1 + steps,
          "one MoE layer routed in every call")
    # router: every token whose expert set differs must sit at a near-tie
    p_noise = max(float((pc_ - pg).abs().max()) for (_, pc_), (_, pg)
                  in zip(cpu["routes"], gpu["routes"]))
    flips = []                                    # (call, token)
    for call, ((ic, pc_), (ig, _)) in enumerate(zip(cpu["routes"],
                                                     gpu["routes"])):
        differ = (ic.sort(-1).values != ig.sort(-1).values).any(-1)
        for t in differ.nonzero().flatten().tolist():
            top = pc_[t].topk(k + 1).values
            gap = float(top[k - 1] - top[k])
            flips.append((call, t))
            print(f"[parity]   deepseek router flip: call {call} token {t}, "
                  f"CPU gap between choice {k} and {k + 1} {gap:.3g} "
                  f"(router noise {p_noise:.3g})")
            check(gap <= 2 * p_noise, f"router flip at call {call} token {t} "
                                      f"sits at a near-tie ({gap:.3g} <= "
                                      f"2 x {p_noise:.3g})")
    # logits: row b of call c reads router token b·S + S - 1 (prefill) or b
    def flipped(c, b):
        return (c, b * S + S - 1 if c == 0 else b) in flips
    clean = [float((lc[b] - lg[b]).abs().max())
             for c, (lc, lg) in enumerate(zip(cpu["logits"], gpu["logits"]))
             for b in range(B) if not flipped(c, b)]
    l_noise = max(clean) if clean else 0.0
    parted = 0
    for c, (lc, lg) in enumerate(zip(cpu["logits"], gpu["logits"])):
        for b in range(B):
            tc, tg = int(lc[b, 0].argmax()), int(lg[b, 0].argmax())
            if tc == tg or flipped(c, b):
                continue
            parted += 1
            margin = float(lc[b, 0].max() - lc[b, 0, tg])
            print(f"[parity]   deepseek call {c} row {b}: CPU token {tc}, "
                  f"card token {tg}, CPU logit margin {margin:.4g}")
            check(margin <= 2 * l_noise, f"deepseek tokens part at a logit "
                                         f"near-tie ({margin:.4g} <= 2 x "
                                         f"{l_noise:.4g})")
    cpu_tok = torch.cat(cpu["tokens"], dim=1).tolist()
    gpu_tok = torch.cat(gpu["tokens"], dim=1).tolist()
    print(f"[parity] deepseek-v2-lite full width, 2 layers (dense + MoE "
          f"64e top-6), f32, card (kernels) vs CPU (plain versions): tokens "
          f"card {gpu_tok} CPU {cpu_tok}; max logit diff {l_noise:.3g} over "
          f"rows without a router flip; router probability noise "
          f"{p_noise:.3g}; router flips {len(flips)}; tokens parted at a "
          f"near-tie {parted}")
    check(l_noise <= 1e-3, f"deepseek parity logits within 1e-3 (got "
                           f"{l_noise:.3g})")
    check(all(bool(torch.isfinite(x).all()) for x in gpu["logits"]),
          "finite logits")
    if not flips and not parted:
        check(cpu_tok == gpu_tok, "card and CPU greedy tokens equal")
    chunk_flash, chunk_offset = phase_parity_mla_chunks(
        "deepseek-v2-lite", cfg, cpu_params, pol, rng)
    return f32_flash, f32_paged, chunk_flash, chunk_offset


def phase_parity_mla_chunks(label: str, cfg, params, pol, rng) -> tuple:
    """One 512-token prompt of a 2-layer full-width MLA model through
    ``chunk_step`` in chunks of 200, 200 and 112 (the last two at offsets
    200 and 400 of a 1024-row latent cache), on the card (keys and values
    decompressed from the latent rows, flash at a query offset) and on the
    CPU (plain versions), MoE ``dense``; then on the card through one
    prefill.  Card and CPU give equal greedy tokens at every chunk's end
    and logits within 1e-3, and so do the card's chunks and its one
    prefill.  Under ``dropping`` a chunk gets the MoE capacity of its own
    tokens, not the prompt's (``ROADMAP.md`` §3), so chunks and one prefill
    part in both packages: printed for the card, not held.  ``params``
    (an ``nn.Module``) moves in place to the card, then to the CPU.
    Returns the card run's f32 flash launches and those with an offset."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import chunk_step, init_decode_caches, prefill
    S, widths = 512, (200, 200, 112)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, (1, S)))

    def chunks(params, dev, moe_impl):
        caches = init_decode_caches(cfg, 1, 1024, dtype=torch.float32,
                                    device=dev)
        out, pos = [], 0
        for w in widths:
            logits, caches = chunk_step(params, prompt[:, pos:pos + w].to(dev),
                                        caches, pos, cfg, policy=pol,
                                        moe_impl=moe_impl)
            out.append(logits.cpu())
            pos += w
        return out, caches

    params = params.to("cuda")
    f0, off0 = fa.KERNEL.launches, fa.KERNEL.offset_launches
    card, caches = chunks(params, "cuda", "dense")
    torch.cuda.synchronize()
    launches = fa.KERNEL.launches - f0
    offset = fa.KERNEL.offset_launches - off0
    one, pc = prefill(params, {"tokens": prompt.cuda()}, cfg, policy=pol,
                      moe_impl="dense")
    rows_err = max(max_err(c["ckv"][:, :S], p["ckv"])
                   for c, p in zip(caches, pc))
    drop, _ = chunks(params, "cuda", "dropping")
    one_drop, _ = prefill(params, {"tokens": prompt.cuda()}, cfg, policy=pol)
    torch.cuda.synchronize()
    one, one_drop = one.cpu(), one_drop.cpu()
    del caches, pc
    cpu, _ = chunks(params.to("cpu"), "cpu", "dense")
    err_cpu = max(max_err(a, b) for a, b in zip(card, cpu))
    err_one = max_err(card[-1], one)
    tok = [int(x.argmax()) for x in card]
    print(f"[parity] {label} full width, 2 layers, f32, chunk_step in chunks "
          f"{list(widths)} (MoE dense): chunk-end tokens card {tok} CPU "
          f"{[int(x.argmax()) for x in cpu]}, max logit diff {err_cpu:.3g}; "
          f"against one prefill on the card: token {int(one.argmax())}, "
          f"logit diff {err_one:.3g}, latent rows {rows_err:.3g}; flash "
          f"launches {launches}, with an offset {offset}; under dropping, "
          f"chunks against one prefill: tokens {int(drop[-1].argmax())} / "
          f"{int(one_drop.argmax())}, logit diff "
          f"{max_err(drop[-1], one_drop):.3g} (not held)")
    check(tok == [int(x.argmax()) for x in cpu],
          f"{label} chunk tokens equal on card and CPU")
    check(err_cpu <= 1e-3, f"{label} chunk logits card vs CPU within 1e-3 "
                           f"(got {err_cpu:.3g})")
    check(tok[-1] == int(one.argmax()) and err_one <= 1e-3,
          f"{label} chunks give one prefill's token and logits within 1e-3 "
          f"(got {err_one:.3g})")
    check(rows_err <= 1e-3, f"{label} chunks write one prefill's latent rows")
    check(offset >= 2 * cfg.n_layers, f"{label} chunks after the first "
                                      f"launched flash with a query offset")
    check(all(bool(torch.isfinite(x).all()) for x in card), "finite logits")
    return launches, offset


def phase_parity_minicpm3(ops: dict) -> dict:
    """minicpm3-4b at full width and 2 layers (MLA, dense MLPs), f32: one
    prefill of two 512-token rows and 4 decode steps (row 1 decoding from
    position 400) on the card through the kernels (flash at dk 96 / dv 64,
    paged MLA at dk 288 / dv 256 with G = 40) and on the CPU through the
    plain versions, the card fed the CPU run's greedy tokens: equal tokens,
    logits within 1e-3; then ``phase_parity_mla_chunks``.  Returns the card
    runs' f32 flash and paged launches by phase."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import (DtypePolicy, decode_step,
                                    init_decode_caches, init_params, prefill)
    cfg = get_config("minicpm3-4b").scaled(n_layers=2)
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu", dtype=torch.float32)
    pol = DtypePolicy(torch.float32, torch.float32, torch.float32)
    rng = np.random.default_rng(5)
    B, S, s_max, steps = 2, 512, 1024, 4
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)))
    runs = {}
    for dev in ("cpu", "cuda"):
        params = cpu_params if dev == "cpu" else cpu_params.to(dev)
        f0 = ops["flash_attention"].KERNEL.launches
        p0 = ops["paged_attention"].KERNEL.launches
        logits, pc = prefill(params, {"tokens": prompt.to(dev)}, cfg,
                             policy=pol)
        caches = init_decode_caches(cfg, B, s_max, dtype=torch.float32,
                                    device=dev)
        for dst, src in zip(caches, pc):
            dst["ckv"][:, :S].copy_(src["ckv"])
        pos = np.array([S, 400], dtype=np.int32)
        all_logits, toks = [logits.cpu()], [logits.argmax(-1).cpu()]
        feed = runs["cpu"]["tokens"] if dev == "cuda" else None
        for step in range(steps):
            tok = feed[step] if feed is not None else toks[-1]
            logits, caches = decode_step(params, tok.to(dev).to(torch.int32),
                                         caches, pos, cfg, policy=pol)
            all_logits.append(logits.cpu())
            toks.append(logits.argmax(-1).cpu())
            pos = pos + 1
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = {
                "flash": ops["flash_attention"].KERNEL.launches - f0,
                "paged": ops["paged_attention"].KERNEL.launches - p0}
        runs[dev] = {"logits": all_logits, "tokens": toks}
        del params, caches, pc
    cpu, gpu = runs["cpu"], runs["cuda"]
    err = max(max_err(a, b) for a, b in zip(cpu["logits"], gpu["logits"]))
    cpu_tok = torch.cat(cpu["tokens"], dim=1).tolist()
    gpu_tok = torch.cat(gpu["tokens"], dim=1).tolist()
    print(f"[parity] minicpm3-4b full width, 2 layers, f32, card (kernels) "
          f"vs CPU (plain versions): tokens card {gpu_tok} CPU {cpu_tok}; "
          f"max logit diff {err:.3g}; launches {launches}")
    check(cpu_tok == gpu_tok, "minicpm3 card and CPU greedy tokens equal")
    check(err <= 1e-3, f"minicpm3 parity logits within 1e-3 (got {err:.3g})")
    check(all(bool(torch.isfinite(x).all()) for x in gpu["logits"]),
          "finite logits")
    check(launches["flash"] > 0 and launches["paged"] > 0,
          "minicpm3 parity ran flash and paged on the card")
    launches["chunk_flash"], launches["chunk_flash_offset"] = (
        phase_parity_mla_chunks("minicpm3-4b", cfg, cpu_params, pol, rng))
    return launches


def ring_greedy(cfg, params, prompts, s_max, steps, impl, bucket=None,
                feed=None) -> tuple:
    """f32 on the card: ``prompts`` right-padded into one batch of
    ``bucket`` tokens (default the longest prompt) and prefilled with each
    row's true length, the caches laid into decode caches of ``s_max``
    positions as the engine's ``_write_slot`` lays them (a ring layer's
    ring of min(window, bucket) slots at the front of its min(window,
    s_max)), then ``steps`` greedy decode steps, through the kernels
    (``impl`` None) or the plain versions (``"plain"``); with ``feed``
    (B, steps + 1) the decode steps take those tokens.  A model fed
    embeddings is prefilled with the prompt tokens' table rows, as the
    engine's bucketed prefill feeds it.  Returns (each step's logits on the
    host, the greedy tokens (B, steps + 1))."""
    import torch
    from repro_torch.models import (DtypePolicy, decode_step,
                                    init_decode_caches, prefill)
    pol = DtypePolicy(torch.float32, torch.float32, torch.float32)
    lens = [len(p) for p in prompts]
    toks = np.zeros((len(prompts), bucket or max(lens)), dtype=np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    toks = torch.tensor(toks, device="cuda")
    batch = ({"tokens": toks} if cfg.input_mode == "tokens" else
             {"embeddings": params.embed[toks].float()})
    logits, pc = prefill(params, batch, cfg, policy=pol, impl=impl,
                         true_lens=torch.tensor(lens, device="cuda"))
    del batch
    caches = init_decode_caches(cfg, len(prompts), s_max,
                                dtype=torch.float32, device="cuda")
    for dst, src in zip(caches, pc):
        for name, t in src.items():
            dst[name][:, :t.shape[1]].copy_(t)
    del pc
    pos = np.asarray(lens, dtype=np.int32)
    out_logits, out_toks = [logits.cpu()], [logits.argmax(-1).cpu()]
    for step in range(steps):
        tok = feed[:, step:step + 1] if feed is not None else out_toks[-1]
        logits, caches = decode_step(params, tok.to("cuda").to(torch.int32),
                                     caches, pos, cfg, policy=pol, impl=impl)
        out_logits.append(logits.cpu())
        out_toks.append(logits.argmax(-1).cpu())
        pos = pos + 1
    return out_logits, torch.cat(out_toks, dim=1)


def logit_gap(a: list, b: list) -> tuple:
    """Largest absolute difference of two runs' logits, and the same over
    the larger logit magnitude."""
    err = max(max_err(x, y) for x, y in zip(a, b))
    scale = max(float(y.abs().max()) for y in b)
    return err, err / scale


def phase_parity_danube(ops: dict) -> dict:
    """h2o-danube-1.8b at full width and 2 layers, f32, on the card: a
    4090-token prompt in decode caches of s_max 4608, so that every layer's
    ring holds the published window W′ = min(4096, 4608) = 4096 slots, then
    16 greedy steps (positions 4090 .. 4105: the ring is full from step 6
    and wraps), through the kernels (flash (80, 80), paged hd 80 with G =
    4 over the ring as pages) and through the plain versions, the kernel
    run fed the plain run's greedy tokens: equal tokens, logits within
    1e-3 of scale.  Returns the kernel run's launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_decode_caches, init_params
    cfg = get_config("h2o-danube-1.8b").scaled(n_layers=2)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda", dtype=torch.float32)
    s_max, steps = 4608, 16
    ring = init_decode_caches(cfg, 1, s_max, dtype=torch.float32,
                              device="cuda")[0]["k"].shape[1]
    check(ring == 4096, f"h2o-danube ring of {ring} slots at s_max {s_max}")
    prompt = np.random.default_rng(11).integers(0, cfg.vocab_size, 4090)
    plain, ptok = ring_greedy(cfg, params, [prompt], s_max, steps, "plain")
    reset_counts(ops)
    kern, ktok = ring_greedy(cfg, params, [prompt], s_max, steps, None,
                             feed=ptok)
    torch.cuda.synchronize()
    launches = ring_launches(ops)
    err, rel = logit_gap(kern, plain)
    print(f"[parity] h2o-danube-1.8b full width, 2 layers, f32, s_max "
          f"{s_max} (rings of {ring}), 4090-token prompt, {steps} greedy "
          f"steps across the window: tokens kernels {ktok.tolist()} plain "
          f"{ptok.tolist()}; max logit diff {err:.3g} ({rel:.3g} of scale); "
          f"launches {launches} (paged: {paged_kernel_of(cfg)})")
    check(torch.equal(ktok, ptok), "h2o-danube kernel and plain greedy "
                                   "tokens equal")
    check(rel <= 1e-3, f"h2o-danube logits within 1e-3 of scale "
                       f"(got {rel:.3g})")
    check(all(bool(torch.isfinite(x).all()) for x in kern), "finite logits")
    check(launches["flash"] == launches["flash_window"] == 2
          and launches["paged"] == 2 * steps,
          "h2o-danube parity ran flash (windowed) and paged on the card")
    del params
    return launches


def phase_parity_gemma3(ops: dict) -> dict:
    """gemma3-4b at full width and one period of 6 layers (5 local of
    window 1024, 1 global), f32, on the card: a 1100-token and a 60-token
    prompt right-padded into one bucket of 2048, each row's rings built
    from its true length, then 16 greedy steps, through the kernels (flash
    (256, 256) windowed and not, paged hd 256 with G = 2 over rings of 1024
    slots and over the global layer's 2048) and through the plain
    versions, the kernel run fed the plain run's tokens: equal tokens,
    logits within 1e-3 of scale; and each prompt prefilled alone at its
    exact length through the kernels gives the batch's tokens, and its
    logits within 1e-4 of scale.  Returns
    the batched kernel run's launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.transformer import layer_kinds
    cfg = get_config("gemma3-4b").scaled(n_layers=6)
    check(layer_kinds(cfg) == ["local"] * 5 + ["global"],
          "gemma3 period: 5 local, 1 global")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda", dtype=torch.float32)
    s_max, steps, bucket = 2048, 16, 2048
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (1100, 60)]
    plain, ptok = ring_greedy(cfg, params, prompts, s_max, steps, "plain",
                              bucket=bucket)
    reset_counts(ops)
    kern, ktok = ring_greedy(cfg, params, prompts, s_max, steps, None,
                             bucket=bucket, feed=ptok)
    torch.cuda.synchronize()
    launches = ring_launches(ops)
    err, rel = logit_gap(kern, plain)
    runs = [ring_greedy(cfg, params, [p], s_max, steps, None)
            for p in prompts]
    alone = [tok[0] for _, tok in runs]
    # each row of the batch against the same prompt alone: its rings were
    # built from its true length, so the bucket's padding must not show
    rel_alone = max(logit_gap([x[i:i + 1] for x in kern], lg)[1]
                    for i, (lg, _) in enumerate(runs))
    print(f"[parity] gemma3-4b full width, 6 layers (5 local, 1 global), "
          f"f32, prompts of 1100 and 60 tokens in a bucket of {bucket}, "
          f"{steps} greedy steps: tokens kernels {ktok.tolist()} plain "
          f"{ptok.tolist()} each alone at its exact length "
          f"{[a.tolist() for a in alone]}; max logit diff {err:.3g} "
          f"({rel:.3g} of scale), batch row against the prompt alone "
          f"{rel_alone:.3g} of scale; launches {launches} (paged: "
          f"{paged_kernel_of(cfg)})")
    check(torch.equal(ktok, ptok), "gemma3 kernel and plain greedy tokens "
                                   "equal")
    check(rel <= 1e-3, f"gemma3 logits within 1e-3 of scale (got {rel:.3g})")
    check(all(bool(torch.isfinite(x).all()) for x in kern), "finite logits")
    check(all(torch.equal(ktok[i], a) for i, a in enumerate(alone)),
          "gemma3 batched tokens equal each prompt's alone")
    check(rel_alone <= 1e-4, f"gemma3 batch rows' logits within 1e-4 of "
                             f"scale of each prompt's alone (got "
                             f"{rel_alone:.3g})")
    check(launches["flash"] == 6 and launches["flash_window"] == 5
          and launches["paged"] == 6 * steps,
          "gemma3 parity ran flash (5 windowed, 1 not) and paged on the "
          "card")
    del params
    return launches


def phase_parity_recurrentgemma(ops: dict) -> dict:
    """recurrentgemma-9b at full width and 5 layers (one period of (rglru,
    rglru, local) and a tail of 2 RG-LRU layers), f32, on the card: a 2040-
    and a 300-token prompt in one unpadded batch (2040 tokens), each row's
    RG-LRU state, conv tail and ring from its true length, decode caches of
    s_max 2100 (the local layer's ring holds the published window, 2048
    slots), then 16 greedy steps (positions 2040 .. 2055: the long row's
    ring wraps), through the kernels (flash (256, 256) windowed at H 16 / K
    1; paged hd 256 at G = 16 over the ring as pages) and through the plain
    versions, the kernel run fed the plain run's tokens: equal tokens,
    logits within 1e-4 of scale; and each prompt prefilled alone through
    the kernels gives the batch's tokens, and its logits within 1e-4 of
    scale.  Returns the batched kernel run's launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.transformer import layer_kinds, stack_layout
    cfg = get_config("recurrentgemma-9b").scaled(n_layers=5)
    check(layer_kinds(cfg) == ["rglru", "rglru", "local", "rglru", "rglru"]
          and stack_layout(cfg) == (0, 1, 2),
          "recurrentgemma cut: one period and a tail of 2 RG-LRU layers")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda", dtype=torch.float32)
    s_max, steps = 2100, 16
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (2040, 300)]
    plain, ptok = ring_greedy(cfg, params, prompts, s_max, steps, "plain")
    reset_counts(ops)
    kern, ktok = ring_greedy(cfg, params, prompts, s_max, steps, None,
                             feed=ptok)
    torch.cuda.synchronize()
    launches = ring_launches(ops)
    err, rel = logit_gap(kern, plain)
    runs = [ring_greedy(cfg, params, [p], s_max, steps, None)
            for p in prompts]
    alone = [tok[0] for _, tok in runs]
    rel_alone = max(logit_gap([x[i:i + 1] for x in kern], lg)[1]
                    for i, (lg, _) in enumerate(runs))
    print(f"[parity] recurrentgemma-9b full width, 5 layers (rglru, rglru, "
          f"local; tail rglru, rglru), f32, prompts of 2040 and 300 tokens "
          f"in one batch, s_max {s_max} (ring of 2048), {steps} greedy steps "
          f"across the window: tokens kernels {ktok.tolist()} plain "
          f"{ptok.tolist()} each alone {[a.tolist() for a in alone]}; max "
          f"logit diff {err:.3g} ({rel:.3g} of scale), batch row against the "
          f"prompt alone {rel_alone:.3g} of scale; launches {launches} "
          f"(paged: {paged_kernel_of(cfg)})")
    check(torch.equal(ktok, ptok), "recurrentgemma kernel and plain greedy "
                                   "tokens equal")
    check(rel <= 1e-4, f"recurrentgemma logits within 1e-4 of scale (got "
                       f"{rel:.3g})")
    check(all(bool(torch.isfinite(x).all()) for x in kern), "finite logits")
    check(all(torch.equal(ktok[i], a) for i, a in enumerate(alone)),
          "recurrentgemma batched tokens equal each prompt's alone")
    check(rel_alone <= 1e-4, f"recurrentgemma batch rows' logits within "
                             f"1e-4 of scale of each prompt's alone (got "
                             f"{rel_alone:.3g})")
    check(launches["flash"] == launches["flash_window"] == 1
          and launches["paged"] == steps,
          "recurrentgemma parity ran flash (windowed) and paged on the card")
    del params
    return launches


def phase_parity_decoder(arch: str, ops: dict, seed: int, steps: int,
                         bucket: int | None = None, note: str = "") -> dict:
    """``arch`` at full width and 2 layers, f32, on the card: a 900- and a
    61-token prompt in one batch (right-padded to ``bucket``, default the
    longer, with their true lengths; a model fed embeddings gets their table
    rows), then ``steps`` greedy steps, through the kernels (flash, and
    paged over slots of 1024) and through the plain versions, the kernel
    run fed the plain run's tokens: equal tokens, logits within 1e-4 of
    scale.  Returns the kernel run's launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config(arch).scaled(n_layers=2)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda", dtype=torch.float32)
    s_max = 1024
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (900, 61)]
    plain, ptok = ring_greedy(cfg, params, prompts, s_max, steps, "plain",
                              bucket=bucket)
    reset_counts(ops)
    kern, ktok = ring_greedy(cfg, params, prompts, s_max, steps, None,
                             bucket=bucket, feed=ptok)
    torch.cuda.synchronize()
    launches = ring_launches(ops)
    err, rel = logit_gap(kern, plain)
    print(f"[parity] {arch} full width, 2 of {get_config(arch).n_layers} "
          f"layers, f32{note}, prompts of 900 and 61 tokens in one batch of "
          f"{bucket or 900}, {steps} greedy steps: tokens kernels "
          f"{ktok.tolist()} plain {ptok.tolist()}; max logit diff {err:.3g} "
          f"({rel:.3g} of scale); launches {launches} (paged: "
          f"{paged_kernel_of(cfg)})")
    check(torch.equal(ktok, ptok), f"{arch} kernel and plain greedy tokens "
                                   f"equal")
    check(rel <= 1e-4, f"{arch} logits within 1e-4 of scale (got "
                       f"{rel:.3g})")
    check(all(bool(torch.isfinite(x).all()) for x in kern), "finite logits")
    check(launches["flash"] == 2 and launches["flash_window"] == 0
          and launches["paged"] == 2 * steps,
          f"{arch} parity ran flash and paged on the card")
    del params
    return launches


def phase_parity_hubert(ops: dict) -> dict:
    """hubert-xlarge on the card.  First its published widths at 2 of 48
    layers in f32: per-position logits of one forward (``models.prefill``
    of an encoder: bidirectional flash at (80, 80), H = K = 16, GeLU MLPs)
    through the kernels against the plain versions, for frame embeddings
    drawn with numpy from a seed (B=2, S=1000: the last key tile ragged),
    within 1e-4 of the logits' scale.  Then the 48-layer bf16 forward at
    B=8 × S=1024, random weights from a seed: the counts set to 0 just
    before its first forward and read just after (48 flash launches, all
    bidirectional), logits finite and of shape (8, 1024, 504), then the
    mean of three more forwards timed by CUDA events.  Returns the f32 and
    bf16 launches and the timings."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import DtypePolicy, init_params, prefill
    fa = ops["flash_attention"]
    full = get_config("hubert-xlarge")
    cfg = full.scaled(n_layers=2)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda", dtype=torch.float32)
    pol = DtypePolicy(torch.float32, torch.float32, torch.float32)
    frames = torch.tensor(np.random.default_rng(18).standard_normal(
        (2, 1000, cfg.d_model)).astype(np.float32), device="cuda")
    plain, _ = prefill(params, {"embeddings": frames}, cfg, policy=pol,
                       impl="plain")
    reset_counts(ops)
    kern, cache = prefill(params, {"embeddings": frames}, cfg, policy=pol)
    torch.cuda.synchronize()
    f32 = fa.KERNEL.launches
    err, rel = logit_gap([kern], [plain])
    print(f"[parity] hubert-xlarge full width, 2 of 48 layers, f32, "
          f"bidirectional, frames (2, 1000, {cfg.d_model}): per-position "
          f"logits {tuple(kern.shape)}, max diff kernels vs plain {err:.3g} "
          f"({rel:.3g} of scale); flash launches {f32}")
    check(cache is None and tuple(kern.shape) == (2, 1000, cfg.vocab_size),
          "hubert prefill returns per-position logits and no cache")
    check(rel <= 1e-4, f"hubert logits within 1e-4 of scale (got {rel:.3g})")
    check(bool(torch.isfinite(kern).all()), "finite logits")
    check(f32 == 2 and fa.KERNEL.window_launches == 0,
          "hubert parity ran flash on the card, twice")
    del params, plain, kern, frames
    gc.collect()
    torch.cuda.empty_cache()

    B, S = 8, 1024
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(full, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda", dtype=torch.bfloat16)
    pol = DtypePolicy(torch.bfloat16, torch.bfloat16, torch.float32)
    frames = torch.tensor(np.random.default_rng(19).standard_normal(
        (B, S, full.d_model)).astype(np.float32), device="cuda")
    batch = {"embeddings": frames}
    reset_counts(ops)
    logits, _ = prefill(params, batch, full, policy=pol)
    torch.cuda.synchronize()
    launches = fa.KERNEL.launches
    check(tuple(logits.shape) == (B, S, full.vocab_size),
          f"hubert logits of shape {(B, S, full.vocab_size)}")
    check(bool(torch.isfinite(logits).all()), "hubert bf16 logits finite")
    check(launches == full.n_layers and fa.KERNEL.window_launches == 0,
          f"hubert forward launched flash once a layer (got {launches})")
    del logits
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        prefill(params, batch, full, policy=pol)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 3
    peak = torch.cuda.max_memory_allocated() / 2**30
    own = peak - base / 2**30
    print(f"[serve] hubert-xlarge {full.n_layers} layers d{full.d_model} "
          f"bf16 forward, B={B} S={S}: {ms:.2f} ms a batch, "
          f"{B * S / ms * 1e3:.0f} frames/s; peak memory {peak:.2f} GiB, the "
          f"phase's own {own:.2f} GiB above {base / 2**30:.2f} GiB live "
          f"before it; flash launches {launches} (bidirectional)")
    del params, frames, batch
    return {"flash": launches, "flash_f32": f32, "ms": ms,
            "frames_per_s": B * S / ms * 1e3, "own_peak_gib": own}


def ring_launches(ops: dict) -> dict:
    """The attention counts of a ring parity since the last
    ``reset_counts``: flash, flash with a window, paged."""
    fa = ops["flash_attention"].KERNEL
    return {"flash": fa.launches, "flash_window": fa.window_launches,
            "paged": ops["paged_attention"].KERNEL.launches}


def paged_kernel_of(cfg) -> str:
    """The paged split kernel an f32 decode of ``cfg`` runs, by its head
    dim and group (``grouped_kernel``), for the parities' launch lines."""
    import torch
    return grouped_kernel(cfg.head_dim, cfg.n_heads // cfg.n_kv_heads,
                          torch.float32)


def reset_counts(ops: dict) -> None:
    """Set every kernel's launch counts to 0."""
    for mod in ops.values():
        mod.KERNEL.launches = 0
    ops["flash_attention"].KERNEL.offset_launches = 0
    ops["flash_attention"].KERNEL.window_launches = 0


def phase_serve(arch: str, ecfg, ops: dict, path: tuple,
                max_peak_gib: float | None = None,
                max_own_gib: float | None = None) -> tuple:
    """``arch`` at full width and depth (or at its card cut,
    ``launch/serve.py::card_config``), bf16, EWSJF, on the card.  Every
    kernel count is set to 0 just before the run and read just after; the
    kernels in ``path`` must have launched, and the peak device memory of
    the run (weights included, and whatever earlier phases still hold) must
    stay under ``max_peak_gib`` when given; the serve's own peak, above what
    was allocated before it, is printed beside it, and must stay under
    ``max_own_gib`` when given.
    Returns (the launches, the serve's result)."""
    import torch
    from repro_torch.launch.serve import card_config, card_requests, depth_label
    from repro_torch.serving.api import serve
    reqs = card_requests()       # 24 at t=0: 19 short, 5 long
    base = torch.cuda.memory_allocated()     # earlier phases' live tensors
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    t0 = time.monotonic()
    out = serve(arch, reqs, smoke=False, config=card_config(arch),
                scheduler="ewsjf", engine_config=ecfg, device="cuda",
                dtype=torch.bfloat16)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: mod.KERNEL.launches for name, mod in ops.items()}
    launches["flash_attention_window"] = \
        ops["flash_attention"].KERNEL.window_launches
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
    peak = torch.cuda.max_memory_allocated() / 2**30
    own = peak - base / 2**30
    short = [r.ttft for r in fin if r.prompt_len <= 128]
    long_ = [r.ttft for r in fin if r.prompt_len > 128]
    print(f"[serve] {arch} {depth_label(cfg)} d{cfg.d_model} bf16 EWSJF: "
          f"{len(fin)} "
          f"requests, {sum(r.generated for r in fin)} tokens in "
          f"{st['elapsed_s']:.2f} s engine time ({wall:.2f} s with weight "
          f"init): {st['tok_per_s']:.1f} tok/s; mean TTFT short "
          f"{np.mean(short):.3f} s long {np.mean(long_):.3f} s; prefill "
          f"batches {st['prefill_batches']} padding_waste "
          f"{st['padding_waste']:.3f} preemptions {st['preemptions']}; peak "
          f"memory {peak:.1f} GiB, the serve's own {own:.1f} GiB above "
          f"{base / 2**30:.1f} GiB live before it; launches {launches}")
    if max_peak_gib is not None:
        check(peak < max_peak_gib, f"{arch} serve peak device memory "
                                   f"{peak:.1f} GiB < {max_peak_gib}")
    if max_own_gib is not None:
        check(own < max_own_gib, f"{arch} serve's own peak device memory "
                                 f"{own:.1f} GiB < {max_own_gib}")
    return launches, out


def phase_prefix_serve(arch: str, params, ops: dict,
                       max_peak_gib: float | None = None) -> dict:
    """``arch`` at full width and depth (``params``, bf16) in chunked
    prefill + radix reuse mode (``card_prefix_engine_config``) over
    shared-prefix traffic (``card_prefix_requests``: one 1024-token prefix,
    16-128-token suffixes, token ids below the vocabulary).  Counts are set
    to 0 just before the run and read just after: flash (also with a query
    offset) and paged attention must have launched.  Every request must
    finish with all its tokens, at least 16 must attach the whole prefix
    (``cached_len == 1024``), the radix must keep its invariants and the
    pool must hold nothing but radix tenancy; the peak device memory of
    the run must stay under ``max_peak_gib`` when given.  Returns the
    launches."""
    import resource

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (card_prefix_engine_config,
                                          card_prefix_requests)
    from repro_torch.serving.api import serve
    reqs = card_prefix_requests(vocab=get_config(arch).vocab_size)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    t0 = time.monotonic()
    out = serve(arch, reqs, smoke=False, scheduler="ewsjf",
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
    host_bytes = sum(slab.nbytes for run in host_runs.values()
                     for layer in run for slab in layer.values())
    peak_dev = torch.cuda.max_memory_allocated() / 2**30
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"[serve] {arch} chunked+radix {eng.cfg.n_layers} layers "
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
          f"{host_bytes / 1e9:.3f} GB in {len(host_runs)} runs ("
          f"{eng._block_bytes()} B a 16-token block); process peak RSS "
          f"{rss:.1f} GiB; launches {launches}")
    if max_peak_gib is not None:
        check(peak_dev < max_peak_gib, f"{arch} prefix serve peak device "
                                       f"memory {peak_dev:.1f} GiB < "
                                       f"{max_peak_gib}")
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


# Training (phase 5 of the docstring): f32 card-against-CPU parity at full
# width, blockwise attention at llama2's heads, the launcher's full-width
# run and checkpoint/restart.  No kernel of the repository runs here.
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-5, 1e-4     # f32, card vs CPU
TRAIN_STEP_TOL = 1e-4                           # 3 AdamW steps' losses
BLOCKWISE_OUT_TOL, BLOCKWISE_GRAD_TOL = 2e-5, 1e-4
TRAIN_MAX_OWN_GIB = 60        # the limit of internvl2's serve (PERF.md)
# (b): (arch, layers at full width, batch, sequence) held card against CPU
# in f32: llama2's GQA, mamba2's SSD (S 384: a whole chunk of 256 and a
# padded one), recurrentgemma's period (rglru, rglru, local), deepseek's
# dense head layer and one MoE layer, minicpm3's MLA with dense MLPs.
# llama2 runs 1 layer (2 until the whole run passed 800 s).  The CPU side
# of recurrentgemma's (117-121 s beside an H100) goes to its 1.7 B
# weights' init, AdamW and the tied table's gradient, not to the tokens:
# 1 x 128 took as long.
TRAIN_PARITY = (("llama2-13b", 1, 2, 128), ("mamba2-370m", 2, 2, 384),
                ("recurrentgemma-9b", 3, 2, 128),
                ("deepseek-v2-lite-16b", 2, 2, 128),
                ("minicpm3-4b", 2, 2, 128))
# (d): ``launch/train.py`` at full width (cut to ``TRAIN_DEPTH_CUTS``
# layers where the model does not fit), bf16 compute, remat; llama2 20
# steps (30 until the whole run passed 800 s)
TRAIN_RUNS = {
    "llama2-13b": ["--steps", "20", "--batch", "2", "--seq", "4096",
                   "--lr", "3e-4"],
    "mamba2-370m": ["--steps", "20", "--batch", "8", "--seq", "4096",
                    "--lr", "1e-3"],
    "recurrentgemma-9b": ["--steps", "20", "--batch", "2", "--seq", "4096",
                          "--lr", "3e-4"],
    "deepseek-v2-lite-16b": ["--steps", "20", "--batch", "2", "--seq",
                             "4096", "--lr", "3e-4"]}


def phase_train_wrappers() -> None:
    """(a) Every kernel wrapper refuses, on the card, an input that
    requires grad under grad mode: its output would have no ``grad_fn``.
    So do the prefill mixers that reach them, ``ssm_forward`` (mamba2's
    smoke weights) and ``mla_forward`` (deepseek's), with weights that
    require grad; their ``train=True`` forms run."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.ssd_scan import ops as so
    from repro_torch.models import init_params
    from repro_torch.models.attention import mla_forward
    from repro_torch.models.ssm import ssm_forward
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    mixers = {}
    for arch in ("mamba2-370m", "deepseek-v2-lite-16b"):
        cfg = get_smoke_config(arch)
        params = init_params(cfg, g, device="cuda").requires_grad_(True)
        mixers[arch] = (cfg, dict(params.blocks[0].mixer))
    x = torch.randn((1, 64, 64), generator=g, device="cuda")
    pos = torch.arange(64, device="cuda")[None]

    def ssm(train):
        cfg, mixer = mixers["mamba2-370m"]
        return ssm_forward(mixer, x, cfg, train=train)

    def mla(train):
        cfg, mixer = mixers["deepseek-v2-lite-16b"]
        return mla_forward(mixer, x, cfg, positions=pos, train=train)

    def r(*shape, grad=False):
        return torch.randn(shape, generator=g, device="cuda",
                           requires_grad=grad)

    table = torch.arange(2, dtype=torch.int32, device="cuda")[None]
    lens = torch.tensor([20], dtype=torch.int32, device="cuda")
    calls = {
        "flash_attention": lambda: fa.flash_attention(
            r(1, 64, 2, 64, grad=True), r(1, 64, 2, 64), r(1, 64, 2, 64)),
        "paged_attention": lambda: pa.paged_attention(
            r(1, 2, 64, grad=True), r(2, 16, 2, 64), r(2, 16, 2, 64), table,
            lens),
        "ssd_chunk": lambda: so.ssd_chunk(
            r(1, 1, 64, 2, 64, grad=True), r(1, 1, 64, 2).abs(), r(2),
            r(1, 1, 64, 1, 64), r(1, 1, 64, 1, 64)),
        "ssm_forward (prefill)": lambda: ssm(False),
        "mla_forward (prefill)": lambda: mla(False)}
    for name, call in calls.items():
        try:
            with torch.enable_grad():
                call()
        except RuntimeError as e:
            check("training attention" in str(e), f"{name} names the "
                                                   f"training attention")
        else:
            raise RuntimeError(f"check failed: {name} took an input that "
                               f"requires grad under autograd")
    with torch.enable_grad():
        check(ssm(True).requires_grad and mla(True).requires_grad,
              "the training forms of the mixers run under autograd")
    print(f"[train] (a) {', '.join(calls)} refuse inputs that require grad "
          f"under autograd on the card; ssm_forward and mla_forward with "
          f"train=True run")


def _loss_grads(params, batch, cfg, pol):
    import torch
    from repro_torch.models import train_loss
    named = dict(params.named_parameters())
    loss = train_loss(params, batch, cfg, policy=pol, remat=False)
    grads = torch.autograd.grad(loss, list(named.values()))
    return float(loss.detach()), dict(zip(named, grads))


def phase_train_parity(arch: str, layers: int, batch: int, seq: int) -> dict:
    """(b) ``arch`` at full width and ``layers`` layers in f32: one
    ``train_loss`` backward and 3 AdamW steps on the card (cuBLAS and CUDA
    autograd, no kernel of the repository) against the CPU, from the same
    weights.  An MoE model's router choices are recorded on both sides
    and printed beside the result."""
    import copy

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import DtypePolicy
    from repro_torch.models import moe as moe_mod
    from repro_torch.training import (AdamWConfig, DataConfig, TokenDataset,
                                      adamw_init, batch_to, init_train_state,
                                      make_train_step)
    cfg = get_config(arch).scaled(n_layers=layers)
    pol = DtypePolicy(torch.float32, torch.float32, torch.float32)
    t0 = time.monotonic()
    cpu_p, cpu_st = init_train_state(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    card_p = copy.deepcopy(cpu_p).to("cuda")
    card_st = adamw_init(card_p)
    n = sum(p.numel() for p in cpu_p.parameters())
    it = TokenDataset(cfg, DataConfig(global_batch=batch,
                                      seq_len=seq)).batches()
    batches = [next(it) for _ in range(3)]
    orig_route = moe_mod._route
    routes = {"cpu": [], "cuda": []}
    try:
        for dev in routes:
            def recording(x2d, router, top_k, _r=routes[dev]):
                gates, idx, probs = orig_route(x2d, router, top_k)
                _r.append(idx.cpu())
                return gates, idx, probs
            moe_mod._route = recording
            if dev == "cpu":
                lc, g_cpu = _loss_grads(cpu_p, batch_to(batches[0], "cpu"),
                                        cfg, pol)
            else:
                lg, g_card = _loss_grads(card_p, batch_to(batches[0], dev),
                                         cfg, pol)
    finally:
        moe_mod._route = orig_route
    same_routes = all(torch.equal(a, b) for a, b in zip(routes["cpu"],
                                                         routes["cuda"]))
    loss_rel = abs(lg - lc) / abs(lc)
    errs = {k: max_err(g_card[k].cpu(), a) / max(float(a.abs().max()), 1e-30)
            for k, a in g_cpu.items()}
    worst_name = max(errs, key=errs.get)
    worst = errs[worst_name]
    del g_cpu, g_card
    opt = AdamWConfig(lr_peak=3e-4, warmup_steps=1, total_steps=3)
    losses = {}
    for dev, p, st in (("cpu", cpu_p, cpu_st), ("cuda", card_p, card_st)):
        step = make_train_step(cfg, opt, remat=False, policy=pol)
        losses[dev] = []
        for b in batches:
            p, st, m = step(p, st, batch_to(b, dev))
            losses[dev].append(float(m["loss"]))
    step_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(losses["cuda"], losses["cpu"]))
    route_note = (f"; router top-{cfg.moe_top_k} of {cfg.n_experts} "
                  f"{'equal' if same_routes else 'PARTED'} on both sides "
                  f"({len(routes['cpu'])} calls)" if cfg.n_experts else "")
    print(f"[train] (b) {arch} full width, {layers} layers, {n:,} "
          f"parameters, f32, batch {batch}x{seq}: loss card {lg:.7f} CPU "
          f"{lc:.7f} (relative {loss_rel:.2e}); worst gradient leaf "
          f"{worst_name} at {worst:.2e} of its scale; 3 AdamW steps' losses "
          f"card {losses['cuda']} CPU {losses['cpu']} (relative "
          f"{step_rel:.2e}){route_note}; {time.monotonic() - t0:.1f} s")
    check(loss_rel <= TRAIN_LOSS_TOL, f"{arch}: card loss within "
                                      f"{TRAIN_LOSS_TOL} of the CPU's (got "
                                      f"{loss_rel:.2e})")
    check(worst <= TRAIN_GRAD_TOL, f"{arch}: every gradient leaf within "
                                   f"{TRAIN_GRAD_TOL} of its scale (got "
                                   f"{worst:.2e} at {worst_name})")
    check(step_rel <= TRAIN_STEP_TOL, f"{arch}: AdamW steps' losses within "
                                      f"{TRAIN_STEP_TOL} (got {step_rel:.2e})")
    return {"layers": layers, "params": n, "loss_rel": loss_rel,
            "grad_worst": worst, "grad_worst_leaf": worst_name,
            "step_losses_card": losses["cuda"],
            "step_losses_cpu": losses["cpu"], "step_loss_rel": step_rel,
            "routes_equal": same_routes if cfg.n_experts else None,
            "wall_s": time.monotonic() - t0}


def phase_train_blockwise() -> dict:
    """(c) ``blockwise_gqa_attend`` at llama2's heads (B 1, S 4096, H = K =
    40, hd 128, f32, causal) against the dense ``reference_attend`` on the
    card, forward and backward, each timed once after a warm call."""
    import torch
    from repro_torch.models.blockwise import (blockwise_gqa_attend,
                                              reference_attend)
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    S, H, hd = 4096, 40, 128
    q, k, v = (torch.randn((1, S, H, hd), generator=g, device="cuda",
                           requires_grad=True) for _ in range(3))
    ct = torch.randn((1, S, H * hd), generator=g, device="cuda")
    res, ms = {}, {}
    for name, fn in (("blockwise", blockwise_gqa_attend),
                     ("reference", reference_attend)):
        for _ in range(2):        # the second call is timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(q, k, v, causal=True)
            grads = torch.autograd.grad(out, (q, k, v), ct)
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3
        res[name] = (out.detach(), *grads)
        del out, grads
    (bo, *bg), (ro, *rg) = res["blockwise"], res["reference"]
    out_err = max_err(bo, ro) / float(ro.abs().max())
    grad_err = max(max_err(a, b) / float(b.abs().max())
                   for a, b in zip(bg, rg))
    print(f"[train] (c) blockwise vs dense reference, B 1 S {S} H = K = {H} "
          f"hd {hd} f32 causal: output within {out_err:.2e} of scale, "
          f"gradients of q, k, v within {grad_err:.2e}; forward + backward "
          f"{ms['blockwise']:.1f} ms blockwise, {ms['reference']:.1f} ms "
          f"dense (one call each, host clock)")
    check(out_err <= BLOCKWISE_OUT_TOL, f"blockwise output within "
                                        f"{BLOCKWISE_OUT_TOL} of scale")
    check(grad_err <= BLOCKWISE_GRAD_TOL, f"blockwise gradients within "
                                          f"{BLOCKWISE_GRAD_TOL} of scale")
    return {"out_err": out_err, "grad_err": grad_err,
            "ms_blockwise": ms["blockwise"], "ms_reference": ms["reference"]}


def phase_train_run(arch: str) -> dict:
    """(d) ``launch/train.py`` in-process: ``arch`` at full width, cut to
    ``TRAIN_DEPTH_CUTS`` layers where it has a cut, ``DtypePolicy.train()``,
    remat, ``TRAIN_RUNS[arch]``'s batch, steps and lr."""
    from repro_torch.configs import get_config
    from repro_torch.launch.op_count import llama2_train_flops, train_flops
    from repro_torch.launch.train import main as train_main
    t0 = time.monotonic()
    args = TRAIN_RUNS[arch]
    batch, seq = (int(args[args.index(k) + 1]) for k in ("--batch", "--seq"))
    out = train_main(["--arch", arch, "--full-config", "--log-every", "5",
                      "--device", "cuda"] + args)
    cfg, losses, norms = out["cfg"], out["losses"], out["grad_norms"]
    model, executed, n_mat = train_flops(out["params"], cfg, batch, seq)
    if arch == "llama2-13b":
        check((model, executed, n_mat) == llama2_train_flops(cfg, batch, seq),
              "train_flops gives llama2's closed-form figures")
    s = out["median_ms"] / 1e3
    mfu = model / s / BF16_PEAK_FLOPS
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    full = get_config(arch).n_layers
    summary = {"layers": cfg.n_layers, "of_layers": full,
               "batch": batch, "seq": seq, "params": sum(
                   p.numel() for p in out["params"].parameters()),
               "matmul_params": n_mat, "median_ms": out["median_ms"],
               "tokens_per_s": out["tokens_per_s"], "model_flops": model,
               "executed_flops": executed, "mfu": mfu,
               "executed_share": executed / s / BF16_PEAK_FLOPS,
               "own_peak_gib": out["own_peak_gib"], "losses": losses,
               "grad_norms": norms, "first5": first, "last5": last,
               "wall_s": time.monotonic() - t0}
    del out
    print(f"[train] (d) {arch} {cfg.n_layers} of {full} layers, "
          f"{summary['params']:,} parameters, bf16 compute, remat, batch "
          f"{batch}x{seq}: median {summary['median_ms']:.1f} ms a step after "
          f"step 3 ({summary['tokens_per_s']:.0f} tokens/s); model FLOPs a "
          f"step {model:.3e} (6·N·tokens, N = {n_mat:,}, plus attention "
          f"and SSD products), {100 * mfu:.2f}% of "
          f"{BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s; executed FLOPs "
          f"{executed:.3e} ({100 * summary['executed_share']:.2f}%); own "
          f"peak {summary['own_peak_gib']:.2f} GiB; loss first 5 {first:.4f} "
          f"last 5 {last:.4f}; {summary['wall_s']:.1f} s with init")
    print(f"[train] (d) {arch} losses {[round(x, 4) for x in losses]}")
    print(f"[train] (d) {arch} gradient norms {[round(x, 4) for x in norms]}")
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"{arch}: finite losses and gradient norms")
    check(last < first, f"{arch}: loss falls on the planted bigram stream "
                        f"(first 5 {first:.4f}, last 5 {last:.4f})")
    check(summary["own_peak_gib"] < TRAIN_MAX_OWN_GIB,
          f"{arch}: the run's own peak {summary['own_peak_gib']:.2f} GiB < "
          f"{TRAIN_MAX_OWN_GIB}")
    return summary


def phase_train_resume() -> dict:
    """(e) llama2-13b's smoke config on the card: 4 straight steps against
    2 steps, a checkpoint, a restore into a fresh state and 2 more, under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``; bitwise
    where they agree bit for bit, else within 1e-6 of scale."""
    import tempfile
    import warnings

    import torch
    from repro_torch import bridge
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.training import (AdamWConfig, DataConfig, TokenDataset,
                                      batch_to, init_train_state,
                                      make_train_step)
    cfg = get_smoke_config("llama2-13b")
    step_fn = make_train_step(cfg, AdamWConfig(lr_peak=1e-3, warmup_steps=2,
                                               total_steps=4))

    def fresh(seed):
        g = torch.Generator(device="cuda")
        g.manual_seed(seed)
        return init_train_state(cfg, g, device="cuda")

    def stream():
        return TokenDataset(cfg, DataConfig(global_batch=2,
                                            seq_len=32)).batches()

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            p1, o1 = fresh(0)
            it = stream()
            for _ in range(4):
                p1, o1, _ = step_fn(p1, o1, batch_to(next(it), "cuda"))
            p2, o2 = fresh(0)
            it = stream()
            for _ in range(2):
                p2, o2, _ = step_fn(p2, o2, batch_to(next(it), "cuda"))
            build = ROOT / "build"
            build.mkdir(exist_ok=True)
            with tempfile.TemporaryDirectory(dir=build) as d:
                save_checkpoint(d, 2, bridge.train_state_tree(p2, o2, cfg))
                p2, o2 = fresh(1)
                _, step, _ = restore_checkpoint(
                    d, bridge.train_state_tree(p2, o2, cfg))
            check(step == 2 and int(o2.step) == 2, "restored step 2")
            for _ in range(2):
                p2, o2, _ = step_fn(p2, o2, batch_to(next(it), "cuda"))
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    pairs = [(a.detach(), b.detach())
             for a, b in zip(p1.parameters(), p2.parameters())]
    bitwise = all(torch.equal(a, b) for a, b in pairs)
    worst = max(max_err(a, b) / max(float(a.abs().max()), 1e-30)
                for a, b in pairs)
    nondet = sorted({str(w.message).split(" does not have a deterministic")[0]
                     for w in caught if "deterministic" in str(w.message)})
    print(f"[train] (e) checkpoint/restart on the card, llama2-13b smoke: 4 "
          f"straight steps against 2 + save + restore + 2: "
          f"{'bitwise equal' if bitwise else f'within {worst:.2e} of scale'}"
          f"; ops without a deterministic implementation: "
          f"{nondet or 'none'}")
    check(bitwise or worst <= 1e-6, f"resumed state within 1e-6 of scale "
                                    f"(got {worst:.2e})")
    return {"bitwise": bitwise, "worst": worst, "nondeterministic": nondet}


def phase_train() -> dict:
    """Phases (a)-(e) of training, every earlier model's weights freed."""
    import torch
    out = {"parity": {}, "run": {}}
    phase_train_wrappers()
    steps = [(("parity", arch), partial(phase_train_parity, arch, *rest))
             for arch, *rest in TRAIN_PARITY]
    steps.append((("blockwise",), phase_train_blockwise))
    steps += [(("run", arch), partial(phase_train_run, arch))
              for arch in TRAIN_RUNS]
    steps.append((("resume",), phase_train_resume))
    for key, fn in steps:
        gc.collect()
        torch.cuda.empty_cache()
        if len(key) == 2:
            out[key[0]][key[1]] = fn()
        else:
            out[key[0]] = fn()
    print("[train] " + json.dumps(out))
    return out


# The mesh phase's sharded serve steps: prompts, their length, the slot
# caches' length and the greedy decode steps
MESH_BATCH, MESH_PROMPT, MESH_S_MAX, MESH_STEPS = 4, 512, 1024, 8


@contextmanager
def one_rank_world():
    """A one-rank NCCL world on the card (its address a free localhost
    port) and a (1, 1) ("data", "model") mesh over it from
    ``launch/mesh.py::make_host_mesh``; the group is destroyed on the way
    out."""
    import socket

    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        check(dist.get_backend() == "nccl", "the mesh phase runs on NCCL")
        yield make_host_mesh(1, device_type="cuda")
    finally:
        dist.destroy_process_group()


def mesh_greedy(cfg, params, tokens, pol=None, moe_impl="dropping",
                forced=None, policy=None):
    """One prefill of ``tokens`` (B, S), its caches copied into slot caches
    of ``MESH_S_MAX`` positions, and ``MESH_STEPS`` greedy decode steps,
    through ``models.model.prefill`` and ``decode_step`` (the cells' serve
    steps).  With ``pol`` the weights are DTensors, and the batches and
    caches are placed by ``pol`` (the caches' sequence over "model") and
    run under ``distributed.spmd.spmd``.  With ``forced`` (B, steps) each
    step is fed those tokens instead of its own greedy ones (teacher
    forcing).  ``policy`` is the dtype policy (default the serve's, bf16).
    Returns (the prefill's and each step's logits (steps + 1, B, V) f32,
    the tokens fed (B, steps))."""
    import contextlib

    import torch
    from repro_torch.distributed.sharding import (distribute_batch,
                                                  distribute_caches)
    from repro_torch.distributed.spmd import is_dtensor, spmd
    from repro_torch.models.common import DtypePolicy
    from repro_torch.models.model import (decode_step, init_decode_caches,
                                          prefill)
    policy = policy or DtypePolicy.serve()

    def whole(t):
        return t.full_tensor() if is_dtensor(t) else t

    def placed(tok):
        return distribute_batch({"t": tok}, pol)["t"] if pol else tok
    B, S = tokens.shape
    ctx = spmd if pol is not None else contextlib.nullcontext
    with ctx():
        batch = {"tokens": tokens}
        logits, caches = prefill(params, distribute_batch(batch, pol)
                                 if pol else batch, cfg, moe_impl=moe_impl,
                                 policy=policy)
        slot = init_decode_caches(cfg, B, MESH_S_MAX, dtype=policy.compute,
                                  device="cuda")
        for c, p in zip(slot, caches):
            for k in c:
                c[k][:, :S] = whole(p[k])
        del caches
        if pol is not None:
            slot = distribute_caches(slot, pol)
        out = [whole(logits)[:, 0].float()]
        toks = []
        for i in range(MESH_STEPS):
            toks.append(out[-1].argmax(-1, keepdim=True).int()
                        if forced is None else forced[:, i:i + 1])
            logits, slot = decode_step(params, placed(toks[-1]), slot, S + i,
                                       cfg, moe_impl=moe_impl, policy=policy)
            out.append(whole(logits)[:, 0].float())
    return torch.stack(out), torch.cat(toks, 1)


def phase_mesh_serve(cfg, params, ops: dict) -> dict:
    """(a) llama2-13b at full width and depth in bf16 (the serve's
    weights): one prefill and ``MESH_STEPS`` greedy decode steps on
    weights distributed under the serve policy on the one-rank (1, 1) mesh
    (no copy: every shard is the whole weight), decode over caches placed
    by ``cache_spec`` (sequence over "model") through the sharded decode
    (each rank's paged partials, then their merge), against the same call
    on the plain weights: equal greedy tokens, and the logits' gap over
    their scale printed.  The flash and paged launches of the sharded run
    are counted by the wrappers (no profiler here: a session in the middle
    of the run left every later session of ``phase_variants`` empty)."""
    import torch
    from repro_torch.distributed.sharding import (ShardingPolicy,
                                                  batch_axes_for,
                                                  distribute_params)
    t0 = time.monotonic()
    rng = np.random.default_rng(31)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (MESH_BATCH, MESH_PROMPT))).int().cuda()
    ref_logits, ref_toks = mesh_greedy(cfg, params, tokens)
    with one_rank_world() as mesh:
        pol = ShardingPolicy(mesh, "serve", cfg,
                             batch_axes=batch_axes_for(mesh))
        before = torch.cuda.memory_allocated()
        dparams = distribute_params(params, pol)
        copied = torch.cuda.memory_allocated() - before
        reset_counts(ops)
        logits, toks = mesh_greedy(cfg, dparams, tokens, pol)
        torch.cuda.synchronize()
        launches = {name: ops[name].KERNEL.launches
                    for name in ("flash_attention", "paged_attention")}
        del dparams
    gap = float((logits - ref_logits).abs().max()
                / ref_logits.abs().max())
    same = bool(torch.equal(toks, ref_toks))
    print(f"[mesh] (a) llama2-13b {cfg.n_layers} layers d {cfg.d_model} "
          f"bf16 on a one-rank NCCL (1, 1) mesh: {MESH_BATCH} prompts of "
          f"{MESH_PROMPT}, {MESH_STEPS} greedy steps over caches of "
          f"{MESH_S_MAX} placed by cache_spec; greedy tokens equal to the "
          f"plain call's: {same}; logits max |d| / scale {gap:.3e}; "
          f"weights copied by distribution {copied} B; launches in the "
          f"sharded run {launches}; {time.monotonic() - t0:.1f} s")
    check(same, "llama2's sharded greedy tokens equal the plain call's")
    check(gap <= BF16_TOL, f"llama2's sharded logits within {BF16_TOL} of "
                           f"scale (got {gap:.3e})")
    check(launches["flash_attention"] == cfg.n_layers
          and launches["paged_attention"] == MESH_STEPS * cfg.n_layers,
          f"the sharded run launched flash once a layer and paged once a "
          f"layer a step (got {launches})")
    check(copied == 0, "distribution on a one-rank mesh copies no weight")
    return {"tokens_equal": same, "logits_gap": gap, "launches": launches,
            "wall_s": time.monotonic() - t0}


def phase_mesh_ep(cfg, params) -> dict:
    """(b) deepseek-v2-lite-16b at full width and depth in bf16 (the
    serve's weights), on DTensor weights over the one-rank mesh: the same
    prefill and greedy steps with its MoE layers through ``ep_a2a``
    (tokens over "data", experts over "model", buckets shipped by
    ``all_to_all_single`` on NCCL) against ``dropping`` on the same mesh
    (``moe_dropping_sharded``).  At one rank the capacity and the pairs'
    order are the same, so the greedy tokens must be equal and the logits
    within the bf16 tolerance of scale; the gap is printed (equality is
    expected).

    Beside it, printed and not held: the sharded run (MLA decode through
    ``sharded_decode``, sharded ``dropping``) against ``dropping`` on the
    plain weights, whose decode merges its partitions in the kernel: the
    first decode step, fed the same token by both, and a run on the
    DTensor weights fed the plain run's tokens, step by step.  In bf16
    the merge order parts the first layer's output by a rounding step
    (2.6e-3 of scale), and the routing among 64 experts, whose 6th and
    7th choices lie 1e-4 to 1e-3 apart, carries it to about 0.15 of
    scale over 27 layers (``PERF.md`` §6, PR 31).  What holds the
    sharded path against the plain one is :func:`phase_mesh_parity`."""
    import torch
    from repro_torch.distributed.sharding import (ShardingPolicy,
                                                  batch_axes_for,
                                                  distribute_params)
    from repro_torch.models.moe import MoECtx
    t0 = time.monotonic()
    rng = np.random.default_rng(32)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (MESH_BATCH, MESH_PROMPT))).int().cuda()
    plain_logits, plain_toks = mesh_greedy(cfg, params, tokens,
                                           moe_impl="dropping")
    with one_rank_world() as mesh:
        pol = ShardingPolicy(mesh, "serve", cfg,
                             batch_axes=batch_axes_for(mesh))
        dparams = distribute_params(params, pol)
        ref_logits, ref_toks = mesh_greedy(cfg, dparams, tokens, pol,
                                           moe_impl="dropping")
        tf_logits, _ = mesh_greedy(cfg, dparams, tokens, pol,
                                   moe_impl="dropping", forced=plain_toks)
        logits, toks = mesh_greedy(
            cfg, dparams, tokens, pol,
            moe_impl=MoECtx("ep_a2a", mesh, batch_axes_for(mesh)))
        torch.cuda.synchronize()
        del dparams

    same = bool(torch.equal(toks, ref_toks))
    step1 = rel_gap(ref_logits[1], plain_logits[1])
    forced = [rel_gap(tf_logits[i], plain_logits[i])
              for i in range(MESH_STEPS + 1)]
    parted = (ref_toks != plain_toks).any(0).nonzero()
    first = int(parted[0]) if len(parted) else None
    print(f"[mesh] (b) deepseek-v2-lite-16b {cfg.n_layers} layers bf16 on the "
          f"one-rank mesh: ep_a2a against dropping, greedy tokens equal "
          f"{same}, logits max |d| / scale "
          f"{rel_gap(logits, ref_logits):.3e} (<= {BF16_TOL}); sharded "
          f"dropping against plain dropping (not held): prefill logits "
          f"{rel_gap(ref_logits[0], plain_logits[0]):.3e} of scale, first "
          f"step fed the same token "
          f"{bool(torch.equal(ref_toks[:, 0], plain_toks[:, 0]))}, its "
          f"logits {step1:.3e} of scale; greedy tokens equal {first is None}"
          f"{'' if first is None else f' (first parting at step {first})'}"
          f"; fed the plain run's tokens, each step's logits "
          f"{', '.join(f'{g:.3e}' for g in forced)} of scale"
          f"; {time.monotonic() - t0:.1f} s")
    check(same, "deepseek's ep_a2a greedy tokens equal dropping's")
    check(rel_gap(logits, ref_logits) <= BF16_TOL,
          f"deepseek's ep_a2a logits within {BF16_TOL} of scale")
    return {"tokens_equal": same, "logits_gap": rel_gap(logits, ref_logits),
            "plain_step1_gap": step1, "plain_forced_gaps": forced,
            "plain_first_parting": first, "wall_s": time.monotonic() - t0}


# (layers, precision, tolerance of scale, whether the argmax is held)
MESH_PARITY_CUTS = ((4, "f32", F32_TOL, True), (1, "bf16", BF16_TOL, False))


def phase_mesh_parity() -> dict:
    """(b) continued: the sharded serve steps held against the plain ones
    at deepseek-v2-lite-16b's full width, cut in depth, with random
    weights from a seed: 4 layers in f32 (the dense first layer and 3 MoE
    layers; the paged MLA kernel's f32 partials, sharded ``dropping``) and
    1 layer in bf16 (the dense first layer: the bf16 MLA partials with no
    routing after them).  On the one-rank mesh, a prefill and
    ``MESH_STEPS`` decode steps over a latent cache placed by
    ``cache_spec``, fed the plain run's greedy tokens: every step's logits
    within the precision's tolerance of scale, and in f32 of the same
    argmax.  The bf16 argmax is printed, not held: a rounding step of the
    merge order moves the logits by up to 6.7e-3 of scale (``PERF.md``
    §6, PR 31), and with random weights the largest of 102,400 logits can
    lie closer than that to the next (the least such margin, over scale,
    is printed)."""
    import torch
    from repro_torch.distributed.sharding import (ShardingPolicy,
                                                  batch_axes_for,
                                                  distribute_params)
    from repro_torch.launch.serve import card_config
    from repro_torch.models.common import DtypePolicy
    from repro_torch.models.model import init_params
    arch = "deepseek-v2-lite-16b"
    out = {}
    for depth, name, tol, hold_argmax in MESH_PARITY_CUTS:
        t0 = time.monotonic()
        dtype = torch.float32 if name == "f32" else torch.bfloat16
        policy = DtypePolicy(dtype, dtype, torch.float32)
        cfg = card_config(arch, {arch: depth})
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            33), device="cuda", dtype=dtype)
        tokens = torch.from_numpy(np.random.default_rng(33).integers(
            0, cfg.vocab_size, (MESH_BATCH, MESH_PROMPT))).int().cuda()
        want, toks = mesh_greedy(cfg, params, tokens, policy=policy)
        with one_rank_world() as mesh:
            pol = ShardingPolicy(mesh, "serve", cfg,
                                 batch_axes=batch_axes_for(mesh))
            got, _ = mesh_greedy(cfg, distribute_params(params, pol), tokens,
                                 pol, forced=toks, policy=policy)
            torch.cuda.synchronize()
        del params
        gaps = [rel_gap(got[i], want[i]) for i in range(MESH_STEPS + 1)]
        same = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
        rows = int((got.argmax(-1) != want.argmax(-1)).sum())
        top2 = want.topk(2, dim=-1).values
        margin = float((top2[..., 0] - top2[..., 1]).min()
                       / want.abs().max())
        print(f"[mesh] (b) {arch} d {cfg.d_model}, {depth} of 27 layers, "
              f"{name}, one-rank mesh, fed the plain run's tokens: sharded "
              f"against plain, prefill and each step's logits "
              f"{', '.join(f'{g:.3e}' for g in gaps)} of scale (<= {tol}); "
              f"argmax equal {same} ({rows} of {got.shape[0] * got.shape[1]} "
              f"rows differ{'' if hold_argmax else ', not held'}; the plain "
              f"top-2 margin at least {margin:.3e} of scale); "
              f"{time.monotonic() - t0:.1f} s")
        check(max(gaps) <= tol,
              f"{arch} {name} at {depth} layers: sharded serve steps within "
              f"{tol} of the plain ones (got {max(gaps):.3e})")
        check(same or not hold_argmax,
              f"{arch} {name} at {depth} layers: sharded logits' argmax "
              f"equal to the plain ones'")
        out[f"{name}_{depth}"] = {"gaps": gaps, "argmax_equal": same}
    return out


def rel_gap(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a - b).abs().max() / b.abs().max())


def phase_mesh_roofline(train: dict) -> dict:
    """(c) llama2-13b's training cut (``TRAIN_DEPTH_CUTS``: 8 of 40 layers,
    2 x 4096) counted on meta by ``launch/op_count.py`` (no mesh): its
    executed FLOPs beside ``llama2_train_flops``' closed form, the
    roofline's compute and memory terms (``launch/roofline.py::
    step_terms``, H100 data-sheet peaks), and the step phase 5 (d)
    measured over the larger term."""
    import torch
    from repro_torch.launch.op_count import OpCounter, llama2_train_flops
    from repro_torch.launch.roofline import step_terms
    from repro_torch.launch.serve import TRAIN_DEPTH_CUTS, card_config
    from repro_torch.models.model import init_params
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_loop import make_train_step
    t0 = time.monotonic()
    run = train["run"]["llama2-13b"]
    B, S = run["batch"], run["seq"]
    cfg = card_config("llama2-13b", TRAIN_DEPTH_CUTS)
    params = init_params(cfg, None, device="meta")
    params.requires_grad_(True)
    batch = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    with OpCounter() as counter:
        make_train_step(cfg, AdamWConfig(), remat=True)(
            params, adamw_init(params), batch)
    counts = counter.summary()
    _, closed, _ = llama2_train_flops(cfg, B, S)
    terms = step_terms(counts)
    bound = max(terms.values())
    measured = run["median_ms"] / 1e3
    print(f"[mesh] (c) llama2-13b {cfg.n_layers} of 40 layers, {B}x{S}, "
          f"counted on meta: executed FLOPs {counts['flops']:.6e} against "
          f"the closed form {closed:.6e} (ratio "
          f"{counts['flops'] / closed:.6f}); bytes {counts['traffic_bytes']:.6e}"
          f"; roofline terms compute {terms['compute']:.4f} s, memory "
          f"{terms['memory']:.4f} s (H100 SXM data sheet); measured step "
          f"{measured:.4f} s = {measured / bound:.3f} x the bound "
          f"({max(terms, key=terms.get)}); {time.monotonic() - t0:.1f} s")
    check(abs(counts["flops"] - closed) <= 0.01 * closed,
          "the counted training step within 1% of llama2_train_flops")
    return {"flops": counts["flops"], "closed_form": closed,
            "traffic_bytes": counts["traffic_bytes"], "terms": terms,
            "measured_s": measured, "measured_over_bound": measured / bound}


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
    from repro_torch.launch.serve import (CARD_ENGINE_CONFIGS,
                                          card_engine_config,
                                          ssm_card_engine_config)

    t_start = time.monotonic()
    phase_setup(kbuild)
    rows, calls = phase_kernels(fa, pa)
    phase_kernels_minicpm3(fa, pa, rows, calls)
    phase_kernels_ring(fa, pa, rows, calls)
    phase_kernels_recurrentgemma(fa, pa, rows, calls)
    phase_kernels_phi35(fa, pa, rows, calls)
    phase_kernels_encoder(fa, rows, calls)
    phase_kernels_internvl2(fa, pa, rows, calls)
    phase_gqa_partitions(pa, rows)
    chunk_cost = phase_mla_chunk_cost(fa)
    phase_ssd_kernel(so, rows, calls)
    f32_launches = phase_parity_llama()
    ssd_f32_launches = phase_parity_mamba2(so)
    print(f"[parity] f32 SSD launches (ssd_chunk_y_tf32x3_kernel, "
          f"ssd_chunk_state_tf32x3_kernel) in the mamba2 parity's kernel run "
          f"{ssd_f32_launches}")
    torch.cuda.empty_cache()
    ops = {"flash_attention": fa, "paged_attention": pa, "ssd_chunk": so}
    llama, out = phase_serve("llama2-13b", card_engine_config(), ops,
                             ("flash_attention", "paged_attention"))
    # the prefix, replay and fleet runs reuse these weights
    params, cfg = out["engine"].params, out["engine"].cfg
    del out
    gc.collect()
    torch.cuda.empty_cache()
    prefix = phase_prefix_serve("llama2-13b", params, ops)
    gc.collect()
    torch.cuda.empty_cache()
    replay = phase_replay(cfg, params, ops)
    gc.collect()
    torch.cuda.empty_cache()
    fleet = phase_fleet(cfg, params, ops)
    gc.collect()
    torch.cuda.empty_cache()
    mesh = {"serve": phase_mesh_serve(cfg, params, ops)}
    del params                         # the weights, engines and stores go
    gc.collect()
    torch.cuda.empty_cache()
    # deepseek-v2-lite only once llama2-13b's weights and caches are gone
    (f32_launches["deepseek_parity"], mla_f32_launches,
     f32_launches["deepseek_chunk_parity"],
     f32_launches["deepseek_chunk_parity_offset"]) = phase_parity_deepseek(ops)
    print(f"[parity] f32 flash launches (flash_fwd_tf32x3_kernel) by parity "
          f"phase {f32_launches}; f32 paged MLA launches "
          f"(paged_mla_tf32x3_kernel) in the deepseek parity's kernel run "
          f"{mla_f32_launches}")
    gc.collect()
    torch.cuda.empty_cache()
    deepseek, out = phase_serve("deepseek-v2-lite-16b",
                                CARD_ENGINE_CONFIGS["deepseek-v2-lite-16b"](),
                                ops,
                                ("flash_attention", "paged_attention"),
                                max_peak_gib=75)
    # the chunked+radix run and the mesh phase's (b) reuse these weights
    params, ds_cfg = out["engine"].params, out["engine"].cfg
    del out
    gc.collect()
    torch.cuda.empty_cache()
    deepseek_prefix = phase_prefix_serve("deepseek-v2-lite-16b", params, ops,
                                         max_peak_gib=75)
    gc.collect()
    torch.cuda.empty_cache()
    mesh["ep_a2a"] = phase_mesh_ep(ds_cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    mesh["parity"] = phase_mesh_parity()
    gc.collect()
    torch.cuda.empty_cache()
    cpm_f32 = phase_parity_minicpm3(ops)
    gc.collect()
    torch.cuda.empty_cache()
    minicpm3, out = phase_serve("minicpm3-4b",
                                CARD_ENGINE_CONFIGS["minicpm3-4b"](), ops,
                                ("flash_attention", "paged_attention"),
                                max_peak_gib=75)
    params = out["engine"].params
    del out
    gc.collect()
    torch.cuda.empty_cache()
    minicpm3_prefix = phase_prefix_serve("minicpm3-4b", params, ops,
                                         max_peak_gib=75)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ring_f32 = {"danube": phase_parity_danube(ops)}
    gc.collect()
    torch.cuda.empty_cache()
    ring_f32["gemma3"] = phase_parity_gemma3(ops)
    gc.collect()
    torch.cuda.empty_cache()
    ecfg = CARD_ENGINE_CONFIGS["h2o-danube-1.8b"]()
    print(f"[serve] h2o-danube-1.8b at s_max {ecfg.s_max}: its rings hold "
          f"min(4096, {ecfg.s_max}) = {min(4096, ecfg.s_max)} slots, the "
          f"whole slot, so the window is inert in this serve; the f32 "
          f"parity above (s_max 4608, rings of 4096) crosses it")
    danube, out = phase_serve("h2o-danube-1.8b", ecfg, ops,
                              ("flash_attention", "paged_attention"),
                              max_peak_gib=75)
    del out
    gc.collect()
    torch.cuda.empty_cache()
    gemma3, out = phase_serve("gemma3-4b", CARD_ENGINE_CONFIGS["gemma3-4b"](),
                              ops, ("flash_attention", "paged_attention"),
                              max_peak_gib=75)
    # every prefill runs 29 local (windowed) and 5 global layers
    local = gemma3["flash_attention_window"]
    glob = gemma3["flash_attention"] - local
    check(local > 0 and 5 * local == 29 * glob,
          f"gemma3 serve's flash launches 29 windowed to 5 not (got {local} "
          f"and {glob})")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    rg_f32 = phase_parity_recurrentgemma(ops)
    gc.collect()
    torch.cuda.empty_cache()
    rgemma, out = phase_serve("recurrentgemma-9b",
                              CARD_ENGINE_CONFIGS["recurrentgemma-9b"](), ops,
                              ("flash_attention", "paged_attention"),
                              max_peak_gib=75)
    # every prefill runs 12 local layers, all windowed
    batches = out["stats"]["prefill_batches"]
    check(rgemma["flash_attention_window"] == rgemma["flash_attention"]
          == 12 * batches, f"recurrentgemma serve's flash launches all "
                           f"windowed, 12 a prefill batch (got "
                           f"{rgemma['flash_attention_window']} windowed of "
                           f"{rgemma['flash_attention']}, {batches} batches)")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    phi_f32 = phase_parity_decoder("phi3.5-moe-42b-a6.6b", ops, seed=14,
                                   steps=8, note=", MoE dropping")
    gc.collect()
    torch.cuda.empty_cache()
    phi35, out = phase_serve("phi3.5-moe-42b-a6.6b",
                             CARD_ENGINE_CONFIGS["phi3.5-moe-42b-a6.6b"](),
                             ops, ("flash_attention", "paged_attention"),
                             max_peak_gib=75)
    del out
    gc.collect()
    torch.cuda.empty_cache()
    qwen3_f32 = phase_parity_decoder("qwen3-4b", ops, seed=15, steps=8,
                                     bucket=1024, note=", qk_norm")
    gc.collect()
    torch.cuda.empty_cache()
    qwen3, out = phase_serve("qwen3-4b", CARD_ENGINE_CONFIGS["qwen3-4b"](),
                             ops, ("flash_attention", "paged_attention"),
                             max_peak_gib=75)
    # the chunked+radix run reuses these weights
    params = out["engine"].params
    del out
    gc.collect()
    torch.cuda.empty_cache()
    qwen3_prefix = phase_prefix_serve("qwen3-4b", params, ops,
                                      max_peak_gib=75)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    hubert = phase_parity_hubert(ops)
    gc.collect()
    torch.cuda.empty_cache()
    ivl_f32 = phase_parity_decoder("internvl2-76b", ops, seed=16, steps=16,
                                   bucket=1024,
                                   note=", prefilled with embeddings")
    gc.collect()
    torch.cuda.empty_cache()
    internvl2, out = phase_serve("internvl2-76b",
                                 CARD_ENGINE_CONFIGS["internvl2-76b"](), ops,
                                 ("flash_attention", "paged_attention"),
                                 max_peak_gib=75, max_own_gib=60)
    del out
    gc.collect()
    torch.cuda.empty_cache()
    mamba, _ = phase_serve("mamba2-370m", ssm_card_engine_config(), ops,
                           ("ssd_chunk",))
    gc.collect()
    torch.cuda.empty_cache()
    # training, with every serve's weights freed: no kernel of the
    # repository runs on its path (phase (a) shows the wrappers refuse it)
    train = phase_train()
    mesh["roofline"] = phase_mesh_roofline(train)
    print("[mesh] " + json.dumps(mesh, default=str))
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
        by_path[name]["deepseek"] = deepseek[name]
        by_path[name]["deepseek_prefix"] = deepseek_prefix[name]
        by_path[name]["minicpm3"] = minicpm3[name]
        by_path[name]["minicpm3_prefix"] = minicpm3_prefix[name]
        by_path[name]["h2o_danube"] = danube[name]
        by_path[name]["gemma3"] = gemma3[name]
        by_path[name]["recurrentgemma"] = rgemma[name]
        by_path[name]["phi35"] = phi35[name]
        by_path[name]["phi35_parity_f32"] = phi_f32[
            {"flash_attention": "flash", "paged_attention": "paged"}[name]]
        by_path[name]["qwen3"] = qwen3[name]
        by_path[name]["qwen3_prefix"] = qwen3_prefix[name]
        by_path[name]["internvl2"] = internvl2[name]
    by_path["flash_attention"]["hubert"] = hubert["flash"]
    by_path["flash_attention"]["qwen3_prefix_offset"] = \
        qwen3_prefix["flash_attention_offset"]
    for path, counts in (("deepseek_prefix", deepseek_prefix),
                         ("minicpm3_prefix", minicpm3_prefix)):
        by_path["flash_attention"][f"{path}_offset"] = \
            counts["flash_attention_offset"]
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
        if name == "paged_attention":
            entry["gqa_partition"] = pa.GQA_PARTITION
        if name in variants:
            entry["variant"] = variants[name]
        if name == "flash_attention":
            # the f32 cases, each with the f32 parity phases' launches at
            # its kind of shape
            fl = f32_launches
            case_launches = {
                "main": (fl["llama2_parity"] + fl["llama2_chunk_parity"]
                         - fl["llama2_chunk_parity_offset"]),
                "offset": fl["llama2_chunk_parity_offset"],
                "mla": fl["deepseek_parity"]}
            entry["f32_cases"] = {
                case: {**rows[f"flash_attention{sfx}_f32"], "launches": n,
                       "variant": variants[f"flash_attention{sfx}_f32"]}
                for (case, n), sfx in zip(case_launches.items(),
                                          ("", "_offset", "_mla"))}
            entry["f32_launches_by_phase"] = fl
            o = rows["flash_attention_offset"]
            entry["offset_case"] = {
                "case": o["case"],
                "launches": prefix["flash_attention_offset"],
                "launches_all": prefix["flash_attention"],
                "max_abs_err": o["max_abs_err"], "ms": o["ms"],
                "plain_ms": o["plain_ms"], "bound_ms": o["bound_ms"],
                "bound_by": o["bound_by"], "library_ms": o["library_ms"],
                "variant": variants["flash_attention_offset"]}
        if name == "ssd_chunk":
            entry["f32_case"] = {**rows["ssd_chunk_f32"],
                                 "launches": ssd_f32_launches,
                                 "variant": variants["ssd_chunk_f32"]}
        if f"{name}_mla" in rows:
            o = rows[f"{name}_mla"]
            entry["mla_case"] = {
                "case": o["case"], "launches": deepseek[name],
                "max_abs_err": o["max_abs_err"], "ms": o["ms"],
                "plain_ms": o["plain_ms"], "bound_ms": o["bound_ms"],
                "bound_by": o["bound_by"], "library_ms": o["library_ms"],
                "variant": variants[f"{name}_mla"]}
            if "ms_by_partition" in o:
                entry["mla_case"]["ms_by_partition"] = o["ms_by_partition"]
            if f"{name}_mla_f32" in variants:
                entry["mla_case"]["f32_variant"] = variants[f"{name}_mla_f32"]
            if name == "paged_attention":
                # f32 MLA decode, with the deepseek f32 parity's launches
                entry["mla_case"]["f32_case"] = {
                    **rows["paged_attention_mla_f32"],
                    "launches": mla_f32_launches,
                    "variant": variants["paged_attention_mla_f32"]}
            if name == "flash_attention":
                # deepseek's chunks: flash at (192, 128) with an offset, and
                # a chunk's decompression against its attention
                entry["mla_case"]["offset_launches"] = \
                    deepseek_prefix["flash_attention_offset"]
                entry["mla_chunk_cost"] = chunk_cost
        if name in ("flash_attention", "paged_attention"):
            # minicpm3-4b's instances: bf16 launches from its serves (the
            # offset case from the chunked+radix one), f32 ones from its
            # 2-layer parity
            cpm = {"flash_attention": [
                       ("main", "", minicpm3["flash_attention"]),
                       ("main_f32", "_f32", cpm_f32["flash"]
                        + cpm_f32["chunk_flash"]
                        - cpm_f32["chunk_flash_offset"]),
                       ("offset", "_offset",
                        minicpm3_prefix["flash_attention_offset"]),
                       ("offset_f32", "_offset_f32",
                        cpm_f32["chunk_flash_offset"])],
                   "paged_attention": [
                       ("main", "", minicpm3["paged_attention"]),
                       ("main_f32", "_f32", cpm_f32["paged"])]}[name]
            entry["minicpm3_cases"] = {
                case: {**rows[f"{name}_cpm{sfx}"], "launches": n,
                       "variant": variants[f"{name}_cpm{sfx}"]}
                for case, sfx, n in cpm}
            # the sliding-window families' instances: bf16 launches from
            # their serves, f32 ones from their parities.  Flash counts its
            # windowed launches (gemma3's local layers) apart; paged counts
            # one total for hd 256, G = 2, rings and global slots together
            fd, fg = ring_f32["danube"], ring_f32["gemma3"]
            if name == "flash_attention":
                gw = gemma3["flash_attention_window"]
                ring = [("danube", danube[name]),
                        ("danube_f32", fd["flash"]),
                        ("gemma3_local", gw),
                        ("gemma3_local_f32", fg["flash_window"]),
                        ("gemma3_global", gemma3[name] - gw),
                        ("gemma3_global_f32",
                         fg["flash"] - fg["flash_window"])]
            else:
                ring = [("danube", danube[name]),
                        ("danube_f32", fd["paged"]),
                        ("gemma3", gemma3[name]),
                        ("gemma3_f32", fg["paged"])]
            entry["ring_cases"] = {
                case: {**rows[f"{name}_{case}"], "launches": n,
                       "variant": variants[f"{name}_{case}"]}
                for case, n in ring}
            if name == "paged_attention":
                # the same instance over 8 wrapped rings: its launches are
                # in the gemma3 case's
                for sfx in ("", "_f32"):
                    entry["ring_cases"][f"gemma3{sfx}"]["ring_case"] = {
                        **rows[f"{name}_gemma3_ring{sfx}"],
                        "variant": variants[f"{name}_gemma3_ring{sfx}"]}
            # recurrentgemma-9b's instances (MQA at hd 256: flash at H 16 /
            # K 1 windowed, paged at G = 16): bf16 launches from its serve,
            # f32 ones from its 5-layer parity
            short = {"flash_attention": "flash",
                     "paged_attention": "paged"}[name]
            entry["recurrentgemma_cases"] = {
                case: {**rows[f"{name}_rg{sfx}"], "launches": n,
                       "variant": variants[f"{name}_rg{sfx}"]}
                for case, sfx, n in (("main", "", rgemma[name]),
                                     ("main_f32", "_f32", rg_f32[short]))}
            if name == "paged_attention":
                # the same instance over 8 full rings of 2048
                for sfx in ("", "_f32"):
                    entry["recurrentgemma_cases"][f"main{sfx}"][
                        "ring_case"] = {
                        **rows[f"{name}_rg_ring{sfx}"],
                        "variant": variants[f"{name}_rg_ring{sfx}"]}
            # phi3.5-moe's instances (GQA at hd 128, G = 4): bf16 launches
            # from its serve, f32 ones from its 2-layer parity
            entry["phi35_cases"] = {
                case: {**rows[f"{name}_phi35{sfx}"], "launches": n,
                       "variant": variants[f"{name}_phi35{sfx}"]}
                for case, sfx, n in (("main", "", phi35[name]),
                                     ("main_f32", "_f32", phi_f32[short]))}
            if name == "paged_attention":
                # the same instance with one long slot among short ones
                for sfx in ("", "_f32"):
                    entry["phi35_cases"][f"main{sfx}"]["long_case"] = {
                        **rows[f"{name}_phi35_long{sfx}"],
                        "variant": variants[f"{name}_phi35_long{sfx}"]}
            # qwen3-4b runs phi3.5's instances at its heads (H 32 / K 8, hd
            # 128): the phi3.5 rows, with qwen3's launches (bf16 from its
            # serve, f32 from its 2-layer parity, and its chunked+radix
            # serve's)
            entry["qwen3_cases"] = {
                case: {**rows[f"{name}_phi35{sfx}"], "launches": n,
                       "variant": variants[f"{name}_phi35{sfx}"],
                       "timed_as": f"{name}_phi35{sfx}"}
                for case, sfx, n in (("main", "", qwen3[name]),
                                     ("main_f32", "_f32", qwen3_f32[short]))}
            entry["qwen3_cases"]["prefix"] = {
                "launches": qwen3_prefix[name],
                **({"offset_launches": qwen3_prefix["flash_attention_offset"]}
                   if name == "flash_attention" else {})}
            # internvl2-76b's instances (GQA at hd 128, G = 8): bf16
            # launches from its serve at 24 of 80 layers, f32 ones from its
            # 2-layer parity
            entry["internvl2_cases"] = {
                case: {**rows[f"{name}_internvl2{sfx}"], "launches": n,
                       "variant": variants[f"{name}_internvl2{sfx}"]}
                for case, sfx, n in (("main", "", internvl2[name]),
                                     ("main_f32", "_f32", ivl_f32[short]))}
            if name == "paged_attention":
                for sfx in ("", "_f32"):
                    entry["internvl2_cases"][f"main{sfx}"]["long_case"] = {
                        **rows[f"{name}_internvl2_long{sfx}"],
                        "variant": variants[f"{name}_internvl2_long{sfx}"]}
            else:
                # hubert-xlarge's instance: flash (80, 80) bidirectional,
                # bf16 launches from its 48-layer forward, f32 ones from its
                # 2-layer parity
                entry["hubert_cases"] = {
                    case: {**rows[f"{name}_hubert{sfx}"], "launches": n,
                           "variant": variants[f"{name}_hubert{sfx}"]}
                    for case, sfx, n in (("main", "", hubert["flash"]),
                                         ("main_f32", "_f32",
                                          hubert["flash_f32"]))}
                entry["hubert_cases"]["forward"] = {
                    k: hubert[k] for k in ("ms", "frames_per_s",
                                           "own_peak_gib")}
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
