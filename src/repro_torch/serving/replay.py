"""DES↔engine replay-equivalence harness (the port's twin of the JAX
package's ``serving/replay.py``).

The repo runs the same ``core.scheduler`` policies above two executors: the
discrete-event ``core.simulator.ServingSimulator`` (the paper's evaluation
vehicle) and the torch ``serving.engine.ServingEngine``.  This module feeds
one recorded arrival trace through both and bounds their divergence — the
calibration evidence that DES results transfer to the real engine
(docs/ENGINE.md documents the full methodology).

What is bounded
---------------
* **Dispatch order** — under a saturated burst (all arrivals at t=0) with a
  generous KV pool, admission is driven purely by the shared scheduler +
  ``BatchBuilder`` code, so FCFS and SJF must produce *identical* dispatch
  sequences on both executors (``dispatch_match``).  EWSJF couples its
  scores to wall-clock waiting times, which differ between simulated and
  real seconds, so it gets a rank-correlation bound instead
  (``dispatch_tau``).
* **TTFT ordering** — per-request TTFTs are compared as *rankings*
  (Kendall's tau).  Absolute TTFTs are incomparable: the DES charges
  roofline step times of its ``CostModel`` (by default one H100's
  data-sheet peaks), the engine measures real wall clock on its device.

What is NOT bounded: absolute latencies, decode-phase timing, preemption
counts under KV pressure (pool pressure is deliberately excluded — the
harness pins down *scheduling* equivalence, not cost-model calibration).

Beside the JAX harness's report keys, each report carries the engine's
greedy tokens per request (``engine_tokens``) and its output rate
(``engine_tok_per_s`` over ``engine_elapsed_s``).  The engine runs on
``device`` (default ``"cuda"``); tests pass ``"cpu"``.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from ..configs import get_smoke_config
from ..core import EWSJFConfig, EWSJFScheduler, FCFSScheduler, SJFScheduler
from ..core.cost_model import CostModel
from ..core.simulator import EngineParams, ServingSimulator
from ..core.types import Request
from ..models import DtypePolicy, init_params
from ..models.common import resolve_device
from .engine import EngineConfig, ServingEngine

SCHEDULERS = ("fcfs", "sjf", "ewsjf")
#: Schedulers whose dispatch order must match the DES exactly (policy is a
#: pure function of the queue; no wall-clock coupling).
EXACT_SCHEDULERS = ("fcfs", "sjf")
#: Minimum dispatch-order rank correlation tolerated for wall-clock-coupled
#: schedulers (EWSJF) — the documented divergence bound.
TAU_BOUND = 0.6


def make_scheduler(name: str):
    """Fresh scheduler instance by registry name (fcfs / sjf / ewsjf)."""
    if name == "fcfs":
        return FCFSScheduler()
    if name == "sjf":
        return SJFScheduler()
    if name == "ewsjf":
        return EWSJFScheduler(EWSJFConfig(min_history=8, reopt_interval=0.5))
    raise KeyError(f"unknown scheduler {name!r}")


def burst_trace(n: int = 12, seed: int = 0, vocab_size: int = 256,
                short: tuple[int, int] = (16, 96),
                long: tuple[int, int] = (150, 230),
                long_frac: float = 0.25,
                out_range: tuple[int, int] = (3, 9)) -> list[Request]:
    """A recorded mixed arrival trace, saturated (every arrival at t=0) so
    dispatch order is a pure function of scheduler policy.  Prompt tokens
    are materialized explicitly so both executors see identical requests."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        if rng.random() < long_frac:
            pl = int(rng.integers(long[0], long[1] + 1))
        else:
            pl = int(rng.integers(short[0], short[1] + 1))
        toks = rng.integers(0, vocab_size, size=(pl,)).astype(np.int32)
        reqs.append(Request(request_id=i, arrival_time=0.0, prompt_len=pl,
                            max_new_tokens=int(rng.integers(*out_range)),
                            prompt_tokens=toks))
    return reqs


def kendall_tau(a: list, b: list) -> float:
    """Kendall rank correlation between two orderings of the same id set
    (hand-rolled O(n²) — traces are small).  1.0 = identical order,
    -1.0 = reversed; 1.0 by convention for degenerate (<2 common) inputs."""
    common = [x for x in a if x in set(b)]
    if len(common) < 2:
        return 1.0
    rank_b = {x: i for i, x in enumerate(b)}
    conc = disc = 0
    for i in range(len(common)):
        for j in range(i + 1, len(common)):
            d = rank_b[common[i]] - rank_b[common[j]]
            if d < 0:
                conc += 1
            elif d > 0:
                disc += 1
    total = conc + disc
    return (conc - disc) / total if total else 1.0


def _ttft_table(reqs: list[Request]) -> dict[int, float]:
    return {r.request_id: r.ttft for r in reqs if r.ttft is not None}


def _weights(arch: str, cfg, params, device, dtype):
    """``(cfg, params)``: the smoke config of ``arch`` unless ``cfg`` is
    given, and random weights in ``dtype`` on ``device`` from a generator
    seeded with 0 (as the JAX harness uses ``PRNGKey(0)``) unless
    ``params`` are given."""
    if cfg is None:
        cfg = get_smoke_config(arch)
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        params = init_params(cfg, gen, device=device, dtype=dtype)
    return cfg, params


def run_replay(trace: list[Request], scheduler: str = "fcfs",
               arch: str = "llama2-13b",
               ecfg: Optional[EngineConfig] = None,
               params=None, cfg=None, *, device="cuda",
               cost: Optional[CostModel] = None) -> dict:
    """Replay one trace through the DES and the real engine; return the
    divergence report.  ``ecfg`` sizes the engine; the DES ``EngineParams``
    are derived from it so both executors run the same budgets.  Pass
    ``cfg``/``params`` to reuse an already-initialized model across calls
    (the engine computes in the weights' dtype); otherwise the smoke config
    of ``arch`` gets f32 weights drawn from seed 0.  ``cost`` prices the
    DES steps (default: the H100 roofline ``CostModel()``)."""
    dev = resolve_device(device)
    cfg, params = _weights(arch, cfg, params, dev, torch.float32)
    ecfg = ecfg or EngineConfig(max_slots=4, s_max=256,
                                kv_pool_tokens=65536,
                                max_prefill_tokens=512)

    # --- DES side ---------------------------------------------------------
    des_log: list[int] = []

    def on_dispatch(reqs, t):
        des_log.extend(r.request_id for r in reqs)

    des_reqs = copy.deepcopy(trace)
    des_params = EngineParams(
        max_num_seqs=ecfg.max_slots,
        max_prefill_tokens=ecfg.max_prefill_tokens,
        kv_pool_tokens=ecfg.kv_pool_tokens,
        block_size=ecfg.block_size,
        decode_steps_per_tick=ecfg.decode_steps_per_tick,
        bucket_pad=True)
    sim = ServingSimulator(make_scheduler(scheduler),
                           cost if cost is not None else CostModel(),
                           des_params, on_dispatch=on_dispatch)
    des_result = sim.run(des_reqs)

    # --- engine side ------------------------------------------------------
    eng_reqs = copy.deepcopy(trace)
    wdt = params.embed.dtype
    eng = ServingEngine(cfg, params, make_scheduler(scheduler), ecfg,
                        policy=DtypePolicy(wdt, wdt, torch.float32),
                        device=dev)
    eng.run(eng_reqs)
    eng_log = [rid for _, rid in eng.dispatch_log]
    st = eng.stats()

    des_ttft = _ttft_table(des_result.finished)
    eng_ttft = _ttft_table(eng.finished)
    common = sorted(set(des_ttft) & set(eng_ttft))
    ttft_tau = kendall_tau(
        sorted(common, key=lambda r: des_ttft[r]),
        sorted(common, key=lambda r: eng_ttft[r]))
    return {
        "scheduler": scheduler,
        "arch": arch,
        "n_requests": len(trace),
        "des_dispatch": des_log,
        "engine_dispatch": eng_log,
        "dispatch_match": des_log == eng_log,
        "dispatch_tau": kendall_tau(des_log, eng_log),
        "ttft_tau": ttft_tau,
        "des_finished": len(des_result.finished),
        "engine_finished": len(eng.finished),
        "des_ttft": {str(k): round(v, 6) for k, v in des_ttft.items()},
        "engine_ttft": {str(k): round(v, 6) for k, v in eng_ttft.items()},
        "exact_required": scheduler in EXACT_SCHEDULERS,
        "tau_bound": TAU_BOUND,
        "engine_tokens": {str(k): list(v)
                          for k, v in sorted(eng.output_tokens.items())},
        "engine_tok_per_s": st["tok_per_s"],
        "engine_elapsed_s": st["elapsed_s"],
    }


def replay_ok(report: dict) -> bool:
    """The harness pass criterion: exact dispatch equality for policy-pure
    schedulers, rank-correlation within the documented bound otherwise, and
    both executors finishing every request."""
    if report["des_finished"] != report["n_requests"]:
        return False
    if report["engine_finished"] != report["n_requests"]:
        return False
    if report["exact_required"]:
        return bool(report["dispatch_match"])
    return report["dispatch_tau"] >= report["tau_bound"]


def run_suite(n: int = 12, seed: int = 0,
              schedulers: tuple = SCHEDULERS,
              arch: str = "llama2-13b",
              ecfg: Optional[EngineConfig] = None, *,
              cfg=None, params=None,
              trace: Optional[list[Request]] = None, device="cuda",
              dtype: torch.dtype = torch.float32,
              cost: Optional[CostModel] = None) -> dict:
    """Replay one burst trace under every scheduler; returns the combined
    divergence report ({"reports": [...], "ok": bool}) the CI step uploads.
    The trace is ``burst_trace(n, seed)`` over the config's vocabulary
    unless ``trace`` is given; ``cfg``, ``params``, ``device`` and ``cost``
    are as in :func:`run_replay`, with weights (in ``dtype``) drawn once."""
    dev = resolve_device(device)
    cfg, params = _weights(arch, cfg, params, dev, dtype)
    if trace is None:
        trace = burst_trace(n=n, seed=seed, vocab_size=cfg.vocab_size)
    reports = [run_replay(trace, s, arch=arch, ecfg=ecfg, params=params,
                          cfg=cfg, device=dev, cost=cost)
               for s in schedulers]
    return {"arch": arch, "n_requests": len(trace), "seed": seed,
            "reports": reports,
            "ok": all(replay_ok(r) for r in reports)}
