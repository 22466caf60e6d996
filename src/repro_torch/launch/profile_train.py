"""Where the time of a training step goes.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \\
        --arch mamba2-370m --batch 8 [--device cuda]

Builds ``launch/train.py``'s state for ``--arch``: the published config,
cut to ``launch/serve.py::TRAIN_DEPTH_CUTS`` layers where it has a cut,
weights from seed 0, ``DtypePolicy.train()``, remat, MoE under
``dropping``, a ``TokenDataset`` batch of ``--batch`` x 4096.  It runs
two steps to warm up, one timed without the profiler (the host clock
around the step, which waits for its loss) and one under
``torch.profiler``, then prints one JSON line: the unprofiled step's ms,
the device time by kernel class (``profile_serve.kernel_class``, the
serve breakdown's classes), the device busy share against the unprofiled
step, and the ``TOP_KERNELS`` kernels with the most device time.  On the
CPU (``--device cpu``) the device times are 0.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..models.common import resolve_device
from ..training import (AdamWConfig, DataConfig, TokenDataset, batch_to,
                        init_train_state, make_train_step)
from .profile_serve import kernel_class
from .serve import TRAIN_DEPTH_CUTS, card_config

TOP_KERNELS = 15
SEQ = 4096                  # the sequence length of every card training run


def profile_step(cfg, batch: int, seq: int, dev: torch.device) -> dict:
    """Warm up, time and profile one train step of ``cfg`` on ``dev``;
    returns the summary."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params, opt_state = init_train_state(cfg, gen, device=dev)
    step = make_train_step(cfg, AdamWConfig(lr_peak=1e-4, warmup_steps=2,
                                            total_steps=10),
                           "dropping" if cfg.n_experts else "dense",
                           remat=True)
    it = TokenDataset(cfg, DataConfig(global_batch=batch,
                                      seq_len=seq)).batches()

    def one_step():
        nonlocal params, opt_state
        b = batch_to(next(it), dev)
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, b)
        float(metrics["loss"])                   # waits for the step
        return (time.perf_counter() - t0) * 1e3

    for _ in range(2):
        one_step()
    step_ms = one_step()
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        one_step()
    device_us: dict[str, float] = {}
    kernels = []
    for ev in prof.key_averages():
        dt = ev.self_device_time_total
        if dt > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            cls = kernel_class(ev.key)
            device_us[cls] = device_us.get(cls, 0.0) + dt
            kernels.append((dt, ev.count, ev.key[:100]))
    kernels.sort(reverse=True)
    busy_ms = sum(device_us.values()) / 1e3
    return {"arch": cfg.name, "layers": cfg.n_layers,
            "batch": batch, "seq": seq, "device": str(dev),
            "step_ms": step_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / step_ms,
            "device_ms_by_class": {k: v / 1e3 for k, v in sorted(
                device_us.items(), key=lambda kv: -kv[1])},
            "top_kernels": [{"ms": dt / 1e3, "count": n, "name": name}
                            for dt, n, name in kernels[:TOP_KERNELS]]}


def main(argv=None) -> None:
    """Parse ``argv``, profile one step of the card config, print the
    summary as JSON."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-13b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(profile_step(card_config(args.arch, TRAIN_DEPTH_CUTS),
                                  args.batch, SEQ,
                                  resolve_device(args.device))))


if __name__ == "__main__":
    main()
