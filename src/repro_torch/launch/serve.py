"""Serving launcher: run the continuous-batching engine with a pluggable
admission scheduler over the paper's mixed workload.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
        --full --device cuda

``--full`` builds the architecture's published config (random bf16 weights
from ``--seed``) and serves the card workload (``card_requests``) with the
architecture's card engine config; without it the smoke config serves the
paper's mixed workload in f32.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..core import (EWSJFConfig, EWSJFScheduler, FCFSScheduler,
                    Request, SJFScheduler)
from ..models import DtypePolicy, init_params
from ..models.common import resolve_device
from ..serving import EngineConfig, ServingEngine


def make_scheduler(name: str):
    """The launcher's scheduler of ``name`` (ewsjf, fcfs or sjf)."""
    if name == "ewsjf":
        return EWSJFScheduler(EWSJFConfig(min_history=8, reopt_interval=1.0,
                                          trial_interval=5.0))
    return {"fcfs": FCFSScheduler, "sjf": SJFScheduler}[name]()


def mixed_requests(n: int, seed: int = 0) -> list[Request]:
    """The paper's mixed workload: 80% short prompts (8-31 tokens), 20%
    long (96-199), 2-9 new tokens each, all arriving at t=0."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        short = rng.random() < 0.8
        ln = int(rng.integers(8, 32)) if short else int(rng.integers(96, 200))
        reqs.append(Request(prompt_len=ln, arrival_time=0.0,
                            max_new_tokens=int(rng.integers(2, 10))))
    return reqs


def card_requests(n: int = 24, seed: int = 0) -> list[Request]:
    """The full-width workload ``chip_smoke.py`` serves on the card: ``n``
    requests at t=0, a fifth long (700-1900 prompt tokens) and the rest
    short (16-128), 8-32 new tokens each."""
    rng = np.random.default_rng(seed)
    n_long = round(n / 5)
    kinds = rng.permutation([True] * n_long + [False] * (n - n_long))
    reqs = []
    for long_ in kinds:
        ln = int(rng.integers(700, 1901) if long_ else rng.integers(16, 129))
        reqs.append(Request(prompt_len=ln, arrival_time=0.0,
                            max_new_tokens=int(rng.integers(8, 33))))
    return reqs


def card_engine_config() -> EngineConfig:
    """Engine sizing of the full-width llama2-13b card run: 8 slots of 2048
    tokens, a 16384-token KV pool, buckets up to 2048, 4096 prefill
    tokens."""
    return EngineConfig(max_slots=8, s_max=2048, block_size=16,
                        kv_pool_tokens=16384,
                        buckets=(64, 128, 256, 512, 1024, 2048),
                        max_prefill_tokens=4096)


def ssm_card_engine_config() -> EngineConfig:
    """Engine sizing of the full-width mamba2-370m card run: 16 slots of
    2048 tokens (a slot's state is 48 layers of 32x64x128 f32, 48 MiB, so
    twice llama2's slots cost 0.8 GB), a 32768-token pool for the
    ``BlockPool`` accounting, 8192 prefill tokens.  Prompts are not padded
    to buckets (``pad_prompts`` is off for the SSM family)."""
    return EngineConfig(max_slots=16, s_max=2048, block_size=16,
                        kv_pool_tokens=32768,
                        buckets=(64, 128, 256, 512, 1024, 2048),
                        max_prefill_tokens=8192)


CARD_ENGINE_CONFIGS = {"llama2-13b": card_engine_config,
                       "mamba2-370m": ssm_card_engine_config}


def main() -> None:
    """Parse arguments, serve the mixed workload, print the run summary."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--scheduler", default="ewsjf",
                    choices=["ewsjf", "fcfs", "sjf"])
    ap.add_argument("--requests", type=int, default=None,
                    help="default: 24 with --full, else 32")
    ap.add_argument("--max-slots", type=int, default=4,
                    help="slots of the smoke run (--full: the card config)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="published config in bf16 instead of the smoke one")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    dtype = torch.bfloat16 if args.full else torch.float32
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = init_params(cfg, gen, device=dev, dtype=dtype)
    sched = make_scheduler(args.scheduler)
    if args.full:
        ecfg = CARD_ENGINE_CONFIGS.get(args.arch, card_engine_config)()
        reqs = card_requests(args.requests or 24, args.seed)
    else:
        ecfg = EngineConfig(max_slots=args.max_slots, s_max=256,
                            kv_pool_tokens=2048, buckets=(32, 64, 128, 256))
        reqs = mixed_requests(args.requests or 32, args.seed)
    eng = ServingEngine(cfg, params, sched, ecfg,
                        policy=DtypePolicy(dtype, dtype, torch.float32),
                        device=dev)
    fin = eng.run(reqs)
    st = eng.stats()
    short_len = 128 if args.full else 32
    ttft = np.asarray([r.ttft for r in fin if r.ttft is not None])
    short = np.asarray([r.ttft for r in fin
                        if r.ttft is not None and r.prompt_len <= short_len])
    print(f"scheduler={args.scheduler} arch={cfg.name} device={dev}")
    for k, v in st.items():
        print(f"  {k:16s} {v:.3f}" if isinstance(v, float) else f"  {k:16s} {v}")
    print(f"  mean_ttft        {ttft.mean():.3f}s")
    if len(short):
        print(f"  mean_ttft_short  {short.mean():.3f}s")


if __name__ == "__main__":
    main()
