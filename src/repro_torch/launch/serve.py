"""Serving launcher: run the continuous-batching engine with a pluggable
admission scheduler over the paper's mixed workload.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
        --full --device cuda

(or ``--arch llama2-13b``, ``--arch qwen3-4b``, ``--arch
deepseek-v2-lite-16b``, ``--arch minicpm3-4b``, ``--arch h2o-danube-1.8b``,
``--arch gemma3-4b``, ``--arch recurrentgemma-9b``, ``--arch
phi3.5-moe-42b-a6.6b``, ``--arch internvl2-76b``: every architecture the
engine serves; hubert-xlarge is encoder-only, has no decode, and the engine
refuses it)

``--full`` builds the architecture's published config (random bf16 weights
from ``--seed``; ``card_config``: for a model larger than one card, its
published widths at the depth of ``CARD_DEPTH_CUTS``) and serves the card
workload (``card_requests``) with the architecture's card engine config;
without it the smoke config serves the paper's mixed workload in f32.  ``--prefix`` (with ``--full``) serves the
shared-prefix traffic (``card_prefix_requests``) in chunked-prefill +
radix-reuse mode (``card_prefix_engine_config``), for any architecture
whose stack runs chunked decode.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..configs.base import ModelConfig
from ..core import (EWSJFConfig, EWSJFScheduler, FCFSScheduler,
                    Request, SJFScheduler)
from ..models import DtypePolicy, init_params, supports_chunked_decode
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


def card_prefix_engine_config() -> EngineConfig:
    """``card_engine_config`` with chunked prefill (512-token chunks) and
    engine-side radix prefix reuse: the full-width run of the chunked and
    radix paths (llama2-13b, deepseek-v2-lite-16b)."""
    ecfg = card_engine_config()
    ecfg.chunk_prefill_tokens = 512
    ecfg.enable_prefix_cache = True
    return ecfg


def card_prefix_requests(n: int = 24, seed: int = 0, vocab: int = 32000,
                         prefix_len: int = 1024) -> list[Request]:
    """Multi-turn / agent traffic for the card's prefix run: ``n`` requests
    at t=0, each one shared ``prefix_len``-token prefix (a system prompt)
    plus its own 16-128-token suffix, 8-32 new tokens, token ids below
    ``vocab`` drawn from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=(prefix_len,)).astype(np.int32)
    reqs = []
    for i in range(n):
        suffix = rng.integers(0, vocab, size=(int(rng.integers(16, 129)),))
        toks = np.concatenate([prefix, suffix.astype(np.int32)])
        reqs.append(Request(prompt_len=len(toks), arrival_time=0.0,
                            max_new_tokens=int(rng.integers(8, 33)),
                            prompt_tokens=toks))
    return reqs


# deepseek-v2-lite-16b serves at llama2-13b's sizing with the MoE
# ``dropping`` path (the engine's default): at 8 slots a decode step routes
# 8 tokens, each to 6 distinct experts, against a capacity of 8 an expert,
# so decode never drops a token.  minicpm3-4b (MLA, dense MLPs, 9.1 GB of
# bf16 weights at its 62 layers) takes the same sizing, and so do the
# sliding-window families, served bucketed (their ring caches refuse
# chunked mode): h2o-danube-1.8b (window 4096, so at s_max 2048 its rings
# are whole slots and the window is inert) and gemma3-4b (29 local layers
# of window 1024 over rings of 1024 rows, 5 global ones over 2048).
# recurrentgemma-9b (26 RG-LRU layers, 12 local MQA layers of window 2048,
# whose rings at s_max 2048 are whole slots) is served bucketed too, its
# prompts unpadded (``pad_prompts`` is off for the hybrid family), and
# phi3.5-moe at its card cut (``CARD_DEPTH_CUTS``) with MoE ``dropping``:
# 8 decode tokens, top-2 of 16 experts, never pass an expert's capacity.
# qwen3-4b (36 layers, d 2560, GQA at hd 128 with qk_norm, ~8.8 GB in bf16)
# and internvl2-76b at its card cut (prompts embedded through the table
# and prefilled as embeddings) take llama2-13b's sizing too.
CARD_ENGINE_CONFIGS = {"llama2-13b": card_engine_config,
                       "qwen3-4b": card_engine_config,
                       "mamba2-370m": ssm_card_engine_config,
                       "deepseek-v2-lite-16b": card_engine_config,
                       "minicpm3-4b": card_engine_config,
                       "h2o-danube-1.8b": card_engine_config,
                       "gemma3-4b": card_engine_config,
                       "recurrentgemma-9b": card_engine_config,
                       "phi3.5-moe-42b-a6.6b": card_engine_config,
                       "internvl2-76b": card_engine_config}
# Layers served on one 80 GB card, for models whose published depth does
# not fit it: phi3.5-moe's 41.87 B parameters are ~84 GB in bf16, and 16 of
# its 32 layers at published widths are ~21.1 B, ~42 GB; internvl2-76b's
# 70.55 B are ~141 GB, and 24 of its 80 layers (0.856 B each) with the
# embedding table and head are ~22.6 B, ~45.3 GB, beside a KV pool of
# ~1.6 GB at ``card_engine_config``.
CARD_DEPTH_CUTS = {"phi3.5-moe-42b-a6.6b": 16, "internvl2-76b": 24}
# Layers trained on one 80 GB card (``launch/train.py --full-config``):
# training keeps f32 weights, gradients and two AdamW moments (16 B a
# parameter) and bf16 casts of the block weights (2 B), so a cut holds
# about 52 GB of state, leaving room for activations under 60 GiB.
# llama2-13b at 8 of 40 layers is 2.87 B parameters, 51.6 GB (its peak on
# the card is in PERF.md); recurrentgemma-9b at 8 of 38 (two periods and
# the 2-layer RG-LRU tail, so the tail trains) is 2,831,396,864, 1.05 B of
# them the tied 256,000 x 4096 table; deepseek-v2-lite-16b at 5 of 27 (the
# dense head layer and 4 MoE layers) is 2,839,831,040; their peaks are in
# PERF.md.  The others are sized by the same rule, not measured: qwen3-4b
# 20 of 36 (2.80 B), gemma3-4b 18 of 34 (three periods, 2.37 B),
# phi3.5-moe 2 of 32 (2.86 B), internvl2-76b 1 of 80 (2.96 B, its
# embedding table and head are 2.1 B), minicpm3-4b 37 of 62
# (2,876,863,232: 67.6 M a layer and 375 M of untied table and head).
# h2o-danube-1.8b (1.83 B), hubert-xlarge (0.94 B) and mamba2-370m
# (368,227,840) train whole.
TRAIN_DEPTH_CUTS = {"llama2-13b": 8, "qwen3-4b": 20, "gemma3-4b": 18,
                    "phi3.5-moe-42b-a6.6b": 2, "internvl2-76b": 1,
                    "recurrentgemma-9b": 8, "deepseek-v2-lite-16b": 5,
                    "minicpm3-4b": 37}


def card_config(arch: str, cuts: dict = CARD_DEPTH_CUTS) -> ModelConfig:
    """The config ``arch`` runs at on one card: its published config, cut
    to ``cuts[arch]`` layers where it has a cut (``CARD_DEPTH_CUTS`` to
    serve, ``TRAIN_DEPTH_CUTS`` to train)."""
    cfg = get_config(arch)
    if arch in cuts:
        cfg = cfg.scaled(n_layers=cuts[arch])
    return cfg


def depth_label(cfg: ModelConfig) -> str:
    """``cfg``'s depth, and against the published depth when it is cut
    (e.g. "16 of 32 layers (cut)")."""
    full = get_config(cfg.name).n_layers
    if cfg.n_layers == full:
        return f"{full} layers"
    return f"{cfg.n_layers} of {full} layers (cut)"


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
    ap.add_argument("--prefix", action="store_true",
                    help="with --full: shared-prefix traffic in chunked-"
                         "prefill + radix-reuse mode")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.prefix and not args.full:
        ap.error("--prefix needs --full")

    dev = resolve_device(args.device)
    cfg = card_config(args.arch) if args.full else get_smoke_config(args.arch)
    if args.prefix and not supports_chunked_decode(cfg):
        ap.error(f"--prefix needs a stack that runs chunked decode; "
                 f"{args.arch} does not")
    dtype = torch.bfloat16 if args.full else torch.float32
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = init_params(cfg, gen, device=dev, dtype=dtype)
    sched = make_scheduler(args.scheduler)
    if args.prefix:
        ecfg = card_prefix_engine_config()
        reqs = card_prefix_requests(args.requests or 24, args.seed,
                                    vocab=cfg.vocab_size)
    elif args.full:
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
    print(f"scheduler={args.scheduler} arch={cfg.name} "
          f"{depth_label(cfg) if args.full else 'smoke'} device={dev}")
    for k, v in st.items():
        print(f"  {k:16s} {v:.3f}" if isinstance(v, float) else f"  {k:16s} {v}")
    print(f"  mean_ttft        {ttft.mean():.3f}s")
    if len(short):
        print(f"  mean_ttft_short  {short.mean():.3f}s")


if __name__ == "__main__":
    main()
