"""One-call serving facade: build an engine around an architecture and a
scheduler and serve a request list.

    from repro_torch.serving.api import serve
    results = serve("llama2-13b", reqs, smoke=False, device="cuda",
                    dtype=torch.bfloat16)
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs import get_config, get_smoke_config
from ..configs.base import ModelConfig
from ..core import EWSJFConfig, EWSJFScheduler, FCFSScheduler, Request, SJFScheduler
from ..models import DtypePolicy, init_params
from ..models.common import resolve_device
from .engine import EngineConfig, ServingEngine

_SCHEDULERS = {
    "fcfs": lambda: FCFSScheduler(),
    "sjf": lambda: SJFScheduler(),
    "ewsjf": lambda: EWSJFScheduler(EWSJFConfig(min_history=8,
                                                reopt_interval=0.5)),
}


def serve(arch: str, requests: list[Request], *, scheduler: str = "ewsjf",
          smoke: bool = True, config: Optional[ModelConfig] = None,
          params=None,
          engine_config: Optional[EngineConfig] = None,
          admission=None, seed: int = 0, device="cuda",
          dtype: torch.dtype = torch.float32) -> dict:
    """Serve ``requests`` to completion; returns {finished, stats, engine}.

    ``smoke=False`` builds the architecture's full published config;
    ``config`` replaces either (``launch/serve.py::card_config``: a model
    larger than one card at a cut depth).
    Without ``params``, random weights are drawn in ``dtype`` on ``device``
    from a generator seeded with ``seed``; the engine computes and caches KV
    in ``dtype``.  ``device`` defaults to ``"cuda"`` and raises when no GPU
    is present."""
    dev = resolve_device(device)
    cfg = config or (get_smoke_config(arch) if smoke else get_config(arch))
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = init_params(cfg, gen, device=dev, dtype=dtype)
    sched = _SCHEDULERS[scheduler]()
    eng = ServingEngine(cfg, params, sched,
                        engine_config or EngineConfig(
                            max_slots=4, s_max=256, kv_pool_tokens=4096,
                            buckets=(32, 64, 128, 256)),
                        policy=DtypePolicy(dtype, dtype, torch.float32),
                        admission=admission, device=dev)
    finished = eng.run(requests)
    return {"finished": finished, "stats": eng.stats(), "engine": eng}
