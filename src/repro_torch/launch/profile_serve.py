"""Where the time of the full-width card run goes.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        [--arch llama2-13b|qwen3-4b|mamba2-370m|deepseek-v2-lite-16b|
                minicpm3-4b|h2o-danube-1.8b|gemma3-4b|recurrentgemma-9b|
                phi3.5-moe-42b-a6.6b|internvl2-76b] \\
        [--prefix] [--trace out.json]

Serves the ``chip_smoke.py`` workload (``card_requests``; the architecture
at full width and depth, or at its card cut (``serve.py::card_config``),
random bf16 weights, EWSJF, its card engine config) three times on the
GPU: once to warm up (cuBLAS handles,
first-call allocations), once timed without the profiler, once under
``torch.profiler``.  ``--prefix`` serves the architecture's chunked-prefill
+ radix-reuse run instead (``card_prefix_requests`` under
``card_prefix_engine_config``; any architecture whose stack runs chunked
decode: llama2-13b, qwen3-4b, deepseek-v2-lite-16b, minicpm3-4b).  Prints both runs' engine wall times, the
device time per kernel class (:func:`kernel_class`; the RG-LRU scan and
gates — every kernel launched inside ``models/rglru.py::linear_scan`` and
``_gates``, whatever its name, taken out of the class its name gives and
also listed by range under ``rglru_s`` —),
each of the port's own
kernels by name under its class, the device busy share against the
unprofiled wall time, and the host time spent in admission and prefill
(``_admit``), chunked prefill (``_prefill_chunk_tick``) and decode
(``_decode_tick``) under the profiler.  The profiler adds host overhead to every launch, so its wall
time is longer than the unprofiled one; the device times are not affected.
"""

from __future__ import annotations

import argparse
import gc
import json

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ..core import EWSJFConfig, EWSJFScheduler
from ..models import DtypePolicy, init_params, supports_chunked_decode
from ..models import rglru
from ..models.common import resolve_device
from ..serving import ServingEngine
from .serve import (CARD_ENGINE_CONFIGS, card_config,
                    card_prefix_engine_config, card_prefix_requests,
                    card_requests)

# The port's own kernels match by the prefix every kernel of their source
# shares (flash_fwd_wgmma_kernel / flash_fwd_tf32x3_kernel; paged_split_kernel,
# paged_gqa_mma_kernel, paged_gqa_tf32x3_kernel, the MLA kernels and
# paged_merge_kernel), so a new variant is counted under its class.  The
# first class whose key a kernel's name holds takes it.
_CLASSES = (("flash_attention", ("flash_fwd_",)),
            ("paged_attention", ("paged_",)),
            ("ssd_chunk", ("ssd_chunk_",)),
            ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "matmul",
                        "splitkreduce")),
            ("moe_dispatch", ("index_add", "topk", "gather", "sort")),
            ("cumsum", ("scan", "cumsum", "flip")),
            ("copy_host_device", ("memcpy htod", "memcpy dtoh")),
            ("copy", ("memcpy", "memset", "copy")),
            ("reduce", ("reduce",)))
_OWN = ("flash_attention", "paged_attention", "ssd_chunk")
# Profiler ranges around the RG-LRU scan and gates (``_trace_rglru``)
_RGLRU_RANGES = (("linear_scan", "rglru.scan"), ("_gates", "rglru.gates"))


def kernel_class(name: str) -> str:
    """The class of a device kernel, by its name: the port's own kernels
    (flash attention, paged attention, SSD chunk), matrix products, MoE
    dispatch (the router's top-k, the scatter into and gather from the
    expert buffers), cumulative sums (MoE dispatch's positions, the SSD
    training path's segment sums, and the flips of their backward), host-
    device copies, device copies and casts, reductions, and the rest
    ("other": the element-wise passes)."""
    low = name.lower()
    for cls, keys in _CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def _trace_rglru() -> None:
    """Wrap ``models/rglru.py``'s scan and gates in profiler ranges
    (``rglru_forward`` and ``rglru_decode`` look them up in the module at
    each call)."""
    for attr, label in _RGLRU_RANGES:
        fn = getattr(rglru, attr)

        def traced(*a, _fn=fn, _label=label):
            with record_function(_label):
                return _fn(*a)
        setattr(rglru, attr, traced)


def _range_kernels(evt) -> list:
    """(name, device µs) of every kernel launched under a CPU event and its
    children."""
    out = [(k.name, k.duration) for k in evt.kernels]
    for child in evt.cpu_children:
        out.extend(_range_kernels(child))
    return out


def _rglru_device_us(prof) -> dict:
    """Device µs by kernel class of the kernels launched inside each RG-LRU
    range: {label: {class: µs}}."""
    labels = {label for _, label in _RGLRU_RANGES}
    out: dict[str, dict] = {label: {} for label in labels}
    for evt in prof.events():
        if (evt.name in labels
                and evt.device_type == torch.autograd.DeviceType.CPU):
            for name, us in _range_kernels(evt):
                cls = kernel_class(name)
                out[evt.name][cls] = out[evt.name].get(cls, 0.0) + us
    return out


def _engine(cfg, params, dev, prefix: bool) -> ServingEngine:
    sched = EWSJFScheduler(EWSJFConfig(min_history=8, reopt_interval=0.5))
    ecfg = (card_prefix_engine_config() if prefix
            else CARD_ENGINE_CONFIGS[cfg.name]())
    return ServingEngine(cfg, params, sched, ecfg,
                         policy=DtypePolicy(torch.bfloat16, torch.bfloat16,
                                            torch.float32), device=dev)


def main() -> None:
    """Warm up, profile one serve run, print the breakdown as JSON."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-13b",
                    choices=sorted(CARD_ENGINE_CONFIGS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefix", action="store_true",
                    help="chunked-prefill + radix-reuse mode over "
                         "shared-prefix traffic")
    ap.add_argument("--trace", default=None,
                    help="write a chrome trace of the profiled run here")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    cfg = card_config(args.arch)
    if args.prefix and not supports_chunked_decode(cfg):
        ap.error(f"--prefix needs a stack that runs chunked decode; "
                 f"{args.arch} does not")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = init_params(cfg, gen, device=dev, dtype=torch.bfloat16)

    def requests():
        if args.prefix:
            return card_prefix_requests(seed=args.seed, vocab=cfg.vocab_size)
        return card_requests(seed=args.seed)

    _engine(cfg, params, dev, args.prefix).run(requests())  # warm-up
    gc.collect()     # a radix engine's caches sit in a reference cycle
    eng = _engine(cfg, params, dev, args.prefix)
    eng.run(requests())
    torch.cuda.synchronize(dev)
    plain_wall = eng.now()
    plain_stats = eng.stats()
    del eng
    gc.collect()

    eng = _engine(cfg, params, dev, args.prefix)
    if "rglru" in cfg.pattern:
        _trace_rglru()
    for attr, label in (("_admit", "engine.prefill"),
                        ("_prefill_chunk_tick", "engine.chunk"),
                        ("_decode_tick", "engine.decode")):
        fn = getattr(eng, attr)

        def traced(*a, _fn=fn, _label=label):
            with record_function(_label):
                return _fn(*a)
        setattr(eng, attr, traced)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fin = eng.run(requests())
        torch.cuda.synchronize(dev)
    wall = eng.now()
    if args.trace:
        prof.export_chrome_trace(args.trace)
    device_us: dict[str, float] = {}
    host_us: dict[str, float] = {}
    own: dict[str, dict] = {cls: {} for cls in _OWN}   # class -> name -> (s, n)
    kernels = []
    for ev in prof.key_averages():
        dt = ev.self_device_time_total
        if ev.key.startswith("engine."):
            # the CPU range, not its mirror on the GPU timeline
            if ev.device_type == torch.autograd.DeviceType.CPU:
                host_us[ev.key] = ev.cpu_time_total
        elif ev.key.startswith("rglru."):
            pass     # a range's mirror on the GPU timeline, not a kernel
        elif dt > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            cls = kernel_class(ev.key)
            device_us[cls] = device_us.get(cls, 0.0) + dt
            kernels.append((dt, ev.count, ev.key[:90]))
            if cls in own:
                own[cls][ev.key[:90]] = {"device_s": dt / 1e6,
                                         "count": ev.count}
    rglru_us = _rglru_device_us(prof)
    for by_cls in rglru_us.values():
        for cls, us in by_cls.items():
            device_us[cls] -= us
            device_us["rglru"] = device_us.get("rglru", 0.0) + us
    busy = sum(device_us.values()) / 1e6
    kernels.sort(reverse=True)
    print(json.dumps({
        "arch": cfg.name,
        "device": torch.cuda.get_device_name(dev),
        "requests": len(fin),
        "tokens": sum(r.generated for r in fin),
        "engine_wall_s": plain_wall,
        "profiled_engine_wall_s": wall,
        "device_busy_s": busy,
        "device_busy_share": busy / plain_wall,
        "device_s_by_class": {k: v / 1e6 for k, v in sorted(
            device_us.items(), key=lambda kv: -kv[1])},
        "own_kernels_by_class": own,
        "rglru_s": {label.split(".")[1]: {cls: us / 1e6 for cls, us in
                                          by_cls.items()}
                    for label, by_cls in rglru_us.items() if by_cls},
        "host_s": {k: v / 1e6 for k, v in host_us.items()},
        "prefill_batches": eng.prefill_batches,
        "chunks": eng.chunks_run,
        "radix_copies_unprofiled": plain_stats["radix_copies"],
        "top_kernels": [{"name": k, "device_s": dt / 1e6, "count": n}
                        for dt, n, k in kernels[:10]],
    }))


if __name__ == "__main__":
    main()
