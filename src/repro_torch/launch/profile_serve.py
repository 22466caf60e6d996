"""Where the time of the full-width card run goes.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        [--arch llama2-13b|mamba2-370m] [--trace out.json]

Serves the ``chip_smoke.py`` workload (``card_requests``; the architecture
at full width and depth, random bf16 weights, EWSJF, its card engine
config) three times on the GPU: once to warm up (cuBLAS handles,
first-call allocations), once timed without the profiler, once under
``torch.profiler``.  Prints both runs' engine wall times, the device time
per kernel class (flash attention, paged attention, SSD chunk, matrix
products, the rest), each of the port's own kernels by name under its class,
the device busy share against the unprofiled wall time, and the
host time spent in prefill (``_admit``) and decode (``_decode_tick``) under
the profiler.  The profiler adds host overhead to every launch, so its wall
time is longer than the unprofiled one; the device times are not affected.
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ..configs import get_config
from ..core import EWSJFConfig, EWSJFScheduler
from ..models import DtypePolicy, init_params
from ..models.common import resolve_device
from ..serving import ServingEngine
from .serve import CARD_ENGINE_CONFIGS, card_requests

# The port's own kernels match by the prefix every kernel of their source
# shares (flash_fwd_kernel / flash_fwd_mma_kernel; paged_split_kernel and
# paged_merge_kernel), so a new variant is counted under its class.
_CLASSES = (("flash_attention", ("flash_fwd_",)),
            ("paged_attention", ("paged_",)),
            ("ssd_chunk", ("ssd_chunk_",)),
            ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "matmul")))
_OWN = ("flash_attention", "paged_attention", "ssd_chunk")


def _kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in _CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def _engine(cfg, params, dev) -> ServingEngine:
    sched = EWSJFScheduler(EWSJFConfig(min_history=8, reopt_interval=0.5))
    return ServingEngine(cfg, params, sched, CARD_ENGINE_CONFIGS[cfg.name](),
                         policy=DtypePolicy(torch.bfloat16, torch.bfloat16,
                                            torch.float32), device=dev)


def main() -> None:
    """Warm up, profile one serve run, print the breakdown as JSON."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-13b",
                    choices=sorted(CARD_ENGINE_CONFIGS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None,
                    help="write a chrome trace of the profiled run here")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = init_params(cfg, gen, device=dev, dtype=torch.bfloat16)
    _engine(cfg, params, dev).run(card_requests(seed=args.seed))  # warm-up
    eng = _engine(cfg, params, dev)
    eng.run(card_requests(seed=args.seed))
    torch.cuda.synchronize(dev)
    plain_wall = eng.now()

    eng = _engine(cfg, params, dev)
    admit, decode = eng._admit, eng._decode_tick

    def traced_admit(now):
        with record_function("engine.prefill"):
            admit(now)

    def traced_decode():
        with record_function("engine.decode"):
            decode()

    eng._admit, eng._decode_tick = traced_admit, traced_decode
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fin = eng.run(card_requests(seed=args.seed))
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
        elif dt > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            cls = _kernel_class(ev.key)
            device_us[cls] = device_us.get(cls, 0.0) + dt
            kernels.append((dt, ev.count, ev.key[:90]))
            if cls in own:
                own[cls][ev.key[:90]] = {"device_s": dt / 1e6,
                                         "count": ev.count}
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
        "host_s": {k: v / 1e6 for k, v in host_us.items()},
        "prefill_batches": eng.prefill_batches,
        "top_kernels": [{"name": k, "device_s": dt / 1e6, "count": n}
                        for dt, n, k in kernels[:10]],
    }))


if __name__ == "__main__":
    main()
