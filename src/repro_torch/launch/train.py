"""Training launcher: train a model on one card (or, with ``--device cpu``,
on the CPU) with checkpoint/restart, ported from the JAX package's
``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama2-13b \\
        --full-config --steps 30 --batch 2 --seq 4096 --lr 3e-4

Without ``--full-config`` it trains the smoke config; with it the published
config, cut for one card to ``launch/serve.py::TRAIN_DEPTH_CUTS`` layers
where the whole model does not fit (llama2-13b at 8 of 40,
recurrentgemma-9b at 8 of 38, deepseek-v2-lite-16b at 5 of 27; mamba2-370m
trains whole).  Every family the JAX package trains runs: attention (GQA
or MLA), MoE (under ``dropping``), SSM and RG-LRU.  Weights come
from seed 0 and the data from ``training.TokenDataset`` (seed 0, a planted
bigram stream); the policy is ``DtypePolicy.train()`` (f32 weights, bf16
compute) with remat on, AdamW warming up over 10 steps then a cosine to
``--steps``.  ``--ckpt-dir`` saves every ``--ckpt-every`` steps and at the
end; ``--resume`` restores the newest step there and fast-forwards the data
stream, so a run that stops and resumes reaches the same state as one that
does not.  Every ``--log-every`` steps it prints loss, gradient norm and lr;
at the end the median ms a step after step 3 (the step alone, batch
creation excluded), tokens a second, and on a GPU the run's own peak
device memory.  ``main(argv)`` runs in-process and returns the run's
numbers and its final state.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..bridge import train_state_tree
from ..checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..configs import get_smoke_config
from ..models.common import resolve_device
from ..training import (AdamWConfig, DataConfig, TokenDataset, batch_to,
                        init_train_state, make_train_step)
from .serve import TRAIN_DEPTH_CUTS, card_config, depth_label

GIB = 2 ** 30


def main(argv=None) -> dict:
    """Parse ``argv``, train, print the summary.  Returns ``{"cfg",
    "losses", "grad_norms", "lrs", "step_ms", "median_ms",
    "tokens_per_s", "own_peak_gib" (None on the CPU), "start", "params",
    "opt_state"}`` for the steps this call ran."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--full-config", action="store_true",
                    help="the published config (cut to TRAIN_DEPTH_CUTS "
                         "layers) instead of the smoke one")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (card_config(args.arch, TRAIN_DEPTH_CUTS) if args.full_config
           else get_smoke_config(args.arch))
    opt_cfg = AdamWConfig(lr_peak=args.lr, warmup_steps=10,
                          total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg,
                              "dropping" if cfg.n_experts else "dense",
                              remat=True)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        live_before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params, opt_state = init_train_state(cfg, gen, device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"train arch={cfg.name} "
          f"{depth_label(cfg) if args.full_config else 'smoke'} "
          f"params={n_params:,} batch={args.batch}x{args.seq} device={dev}",
          flush=True)

    start = 0
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        # in place: the tree's leaves are the state's own tensors
        _, start, _ = restore_checkpoint(
            args.ckpt_dir, train_state_tree(params, opt_state, cfg))
        print(f"resumed from step {start}", flush=True)

    it = TokenDataset(cfg, DataConfig(global_batch=args.batch,
                                      seq_len=args.seq)).batches()
    for _ in range(start):             # the stream where the run stopped
        next(it)

    out = {"losses": [], "grad_norms": [], "lrs": [], "step_ms": []}
    for step in range(start + 1, args.steps + 1):
        batch = batch_to(next(it), dev)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])            # waits for the step
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(loss)
        out["grad_norms"].append(float(metrics["grad_norm"]))
        out["lrs"].append(metrics["lr"])
        if step % args.log_every == 0 or step == args.steps:
            print(f"step {step:5d}  loss={loss:.4f}  "
                  f"gnorm={out['grad_norms'][-1]:.3f}  "
                  f"lr={metrics['lr']:.2e}  ({out['step_ms'][-1]:.0f} ms)",
                  flush=True)
        if args.ckpt_dir and (step % args.ckpt_every == 0
                              or step == args.steps):
            save_checkpoint(args.ckpt_dir, step,
                            train_state_tree(params, opt_state, cfg))

    steady = out["step_ms"][3:] or out["step_ms"]
    out["median_ms"] = float(np.median(steady)) if steady else None
    out["tokens_per_s"] = (args.batch * args.seq / out["median_ms"] * 1e3
                           if steady else None)
    out["own_peak_gib"] = ((torch.cuda.max_memory_allocated(dev)
                            - live_before) / GIB if cuda else None)
    if steady:
        print(f"median {out['median_ms']:.1f} ms a step (steps after 3), "
              f"{out['tokens_per_s']:.0f} tokens/s", flush=True)
    if cuda:
        print(f"own peak device memory {out['own_peak_gib']:.2f} GiB "
              f"(above {live_before / GIB:.2f} GiB live before the run)",
              flush=True)
    out.update(cfg=cfg, start=start, params=params, opt_state=opt_state)
    return out


if __name__ == "__main__":
    main()
