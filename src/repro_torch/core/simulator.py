"""Discrete-event serving simulator (vLLM-style continuous batching).

Reproduces the paper's evaluation methodology on this CPU-only container:
the engine below EWSJF is modeled as a continuous-batching server with

  * a paged-KV block pool (admission requires the prompt to fit; decode
    growth can trigger recompute-mode preemption, as in vLLM),
  * chunked prefill with a per-step token budget,
  * multi-step decode between scheduling ticks (the scheduler tick is a
    step boundary; vLLM's --num-scheduler-steps),
  * bucket-padded prefill batches (static shapes — the step time is
    charged on *padded* tokens, so homogeneous batches are cheaper).

Step times come from the port's ``core/cost_model.py::CostModel``, a
roofline over one H100 SXM's data-sheet peaks unless other peaks are
passed.  All results are "simulator units": they compare schedulers
relatively and are not measurements of the card.

The same Scheduler objects (core/scheduler.py) drive both this simulator and
the torch engine (serving/engine.py); only the executor differs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .batch_builder import BatchBudget
from .cost_model import CostModel
from .scheduler import BaseScheduler
from .types import Request, RequestState


@dataclass
class EngineParams:
    """Budgets of the simulated engine (slots, prefill tokens, KV pool)."""

    max_num_seqs: int = 64              # decode slots
    max_prefill_tokens: int = 8192      # chunked-prefill budget per tick
    kv_pool_tokens: int = 131072        # paged-KV pool capacity
    block_size: int = 16
    decode_steps_per_tick: int = 8      # multi-step decode between ticks
    bucket_pad: bool = True             # static-shape bucket padding
    scheduler_overhead: float = 50e-6   # host-side tick cost (measured µs)
    # Client-abandonment SLO: a request whose TTFT wait exceeds this is
    # abandoned (producing nothing).  The paper's per-scheduler token totals
    # on identical workloads (Table 8: 320k FCFS vs 401k EWSJF) imply
    # exactly this overload behaviour; None disables.
    ttft_timeout: float | None = None

    @property
    def total_blocks(self) -> int:
        """KV pool size in blocks."""
        return self.kv_pool_tokens // self.block_size


@dataclass
class WorkloadSpec:
    """The paper's Mixed Workload: bimodal 32..4096, 80% short / 20% long,
    Poisson arrivals (§6.1)."""

    n_requests: int = 10_000
    arrival_rate: float = 20.0          # requests / s
    short_frac: float = 0.8
    short_range: tuple[int, int] = (32, 256)
    long_range: tuple[int, int] = (1024, 4096)
    mean_output_tokens: float = 11.0    # matches paper's tokens/request
    max_new_tokens: int = 128
    seed: int = 0

    def generate(self) -> list[Request]:
        """Draw the workload's requests from ``seed``."""
        rng = np.random.default_rng(self.seed)
        n = self.n_requests
        inter = rng.exponential(1.0 / self.arrival_rate, size=n)
        arrivals = np.cumsum(inter)
        is_short = rng.random(n) < self.short_frac
        lens = np.where(
            is_short,
            rng.integers(self.short_range[0], self.short_range[1] + 1, size=n),
            rng.integers(self.long_range[0], self.long_range[1] + 1, size=n))
        outs = np.clip(rng.geometric(1.0 / self.mean_output_tokens, size=n),
                       1, self.max_new_tokens)
        return [Request(prompt_len=int(lens[i]), arrival_time=float(arrivals[i]),
                        max_new_tokens=int(outs[i])) for i in range(n)]


def uniform_workload(n: int, lo: int, hi: int, rate: float, seed: int = 0,
                     mean_out: float = 11.0) -> list[Request]:
    """Single-regime workloads for Tables 8–9 (short-only / long-only)."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n))
    lens = rng.integers(lo, hi + 1, size=n)
    outs = np.clip(rng.geometric(1.0 / mean_out, size=n), 1, 128)
    return [Request(prompt_len=int(lens[i]), arrival_time=float(arrivals[i]),
                    max_new_tokens=int(outs[i])) for i in range(n)]


@dataclass
class SimResult:
    """Outcome of one simulated run: finished requests and the counters."""

    total_time: float
    finished: list[Request]
    preemptions: int
    ticks: int
    padded_prefill_tokens: int
    real_prefill_tokens: int
    busy_time: float
    aborted: list[Request] = field(default_factory=list)

    @property
    def abort_rate(self) -> float:
        """Share of requests abandoned past the TTFT timeout."""
        n = len(self.finished) + len(self.aborted)
        return len(self.aborted) / max(n, 1)

    @property
    def req_per_s(self) -> float:
        """Finished requests per simulated second."""
        return len(self.finished) / max(self.total_time, 1e-9)

    @property
    def tok_per_s(self) -> float:
        """Generated tokens per simulated second."""
        toks = sum(r.generated for r in self.finished)
        return toks / max(self.total_time, 1e-9)

    @property
    def padding_waste(self) -> float:
        """Share of charged prefill tokens that were bucket padding."""
        if self.padded_prefill_tokens == 0:
            return 0.0
        return 1.0 - self.real_prefill_tokens / self.padded_prefill_tokens

    @property
    def utilization(self) -> float:
        """Busy share of the simulated time."""
        return self.busy_time / max(self.total_time, 1e-9)

    def ttft_stats(self, short_threshold: int = 256) -> dict:
        """TTFT mean and percentiles over all, short and long requests."""
        ttfts = np.asarray([r.ttft for r in self.finished if r.ttft is not None])
        short = np.asarray([r.ttft for r in self.finished
                            if r.ttft is not None and r.prompt_len <= short_threshold])
        longs = np.asarray([r.ttft for r in self.finished
                            if r.ttft is not None and r.prompt_len > short_threshold])
        def s(a):
            if not len(a):
                return {"mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
            return {"mean": float(a.mean()), "p50": float(np.percentile(a, 50)),
                    "p95": float(np.percentile(a, 95)),
                    "p99": float(np.percentile(a, 99))}
        return {"all": s(ttfts), "short": s(short), "long": s(longs)}


@dataclass
class _Running:
    req: Request
    kv_tokens: int          # KV held (prompt + generated)
    remaining: int          # output tokens still to produce


class ServingSimulator:
    """Event loop: arrivals → scheduler tick (admission) → prefill charge →
    multi-step decode charge → completions/preemptions → repeat."""

    def __init__(self, scheduler: BaseScheduler, cost: CostModel,
                 params: EngineParams | None = None,
                 on_dispatch=None):
        self.sched = scheduler
        self.cost = cost
        self.p = params or EngineParams()
        # Replay-harness hook: ``on_dispatch(requests, t)`` fires once per
        # tick whose admission plan survived abort filtering, before the
        # prefill charge — the DES side of the DES↔engine dispatch-order
        # equivalence check (serving/replay.py).  Pure observation.
        self.on_dispatch = on_dispatch

    def run(self, requests: list[Request], max_sim_time: float = 1e7) -> SimResult:
        """Simulate ``requests`` to completion (or ``max_sim_time``)."""
        p = self.p
        arrivals = sorted(requests, key=lambda r: r.arrival_time)
        ai = 0
        t = 0.0
        busy = 0.0
        running: list[_Running] = []
        free_blocks = p.total_blocks
        finished: list[Request] = []
        aborted: list[Request] = []
        preemptions = 0
        ticks = 0
        padded_total = 0
        real_total = 0
        n_total = len(arrivals)

        def blocks_for(tokens: int) -> int:
            return -(-tokens // p.block_size)

        while len(finished) + len(aborted) < n_total and t < max_sim_time:
            # 1) deliver arrivals up to current time
            while ai < n_total and arrivals[ai].arrival_time <= t:
                self.sched.submit(arrivals[ai], now=t)
                ai += 1
            # idle fast-forward if nothing to do
            if not running and self.sched.waiting() == 0:
                if ai < n_total:
                    t = arrivals[ai].arrival_time
                    continue
                break

            self.sched.maybe_reoptimize(t) if hasattr(
                self.sched, "maybe_reoptimize") else None
            ticks += 1
            t += p.scheduler_overhead

            # 2) admission
            budget = BatchBudget(
                max_requests=p.max_num_seqs - len(running),
                max_tokens=p.max_prefill_tokens,
                kv_blocks_free=free_blocks,
                block_size=p.block_size,
                pad_mode=p.bucket_pad)
            plan = (self.sched.tick(t, budget)
                    if budget.max_requests > 0 else None)
            if plan and plan.requests and p.ttft_timeout is not None:
                live = []
                for r in plan.requests:
                    if r.wait_time(t) > p.ttft_timeout:
                        r.state = RequestState.FAILED
                        r.finish_time = t
                        aborted.append(r)
                    else:
                        live.append(r)
                plan.requests = live
                plan.total_tokens = sum(int(r.prompt_len) for r in live)

            # 3) prefill charge
            if plan and plan.requests:
                if self.on_dispatch is not None:
                    self.on_dispatch(plan.requests, t)
                batch_tokens = plan.total_tokens
                padded = plan.padded_tokens if p.bucket_pad else batch_tokens
                padded = max(padded, batch_tokens)
                mean_ctx = batch_tokens / len(plan.requests)
                dt = self.cost.prefill_step_time(padded, mean_ctx)
                t += dt
                busy += dt
                padded_total += padded
                real_total += batch_tokens
                for r in plan.requests:
                    free_blocks -= blocks_for(r.prompt_len)
                    r.state = RequestState.RUNNING_DECODE
                    r.first_token_time = t          # first token at prefill end
                    r.generated = 1
                    rem = max(r.max_new_tokens - 1, 0)
                    if rem == 0:
                        self._finish(r, t, finished)
                        free_blocks += blocks_for(r.prompt_len)
                    else:
                        running.append(_Running(r, r.prompt_len + 1, rem))

            # 4) decode: up to decode_steps_per_tick token steps
            for _ in range(p.decode_steps_per_tick):
                if not running:
                    break
                # growth-block check → recompute-mode preemption (LIFO)
                need = sum(1 for rr in running
                           if (rr.kv_tokens % p.block_size) == 0)
                while need > free_blocks and len(running) > 1:
                    victim = running.pop()            # most recent admitted
                    free_blocks += blocks_for(victim.kv_tokens)
                    victim.req.state = RequestState.PREEMPTED
                    victim.req.preemptions += 1
                    victim.req.generated = 0
                    victim.req.first_token_time = None
                    self.sched.submit(victim.req, now=t)
                    preemptions += 1
                    need = sum(1 for rr in running
                               if (rr.kv_tokens % p.block_size) == 0)
                total_kv = sum(rr.kv_tokens for rr in running)
                dt = self.cost.decode_step_time(len(running), total_kv)
                t += dt
                busy += dt
                done_idx = []
                for i, rr in enumerate(running):
                    if rr.kv_tokens % p.block_size == 0:
                        free_blocks -= 1
                    rr.kv_tokens += 1
                    rr.req.generated += 1
                    rr.remaining -= 1
                    if rr.remaining <= 0:
                        done_idx.append(i)
                for i in reversed(done_idx):
                    rr = running.pop(i)
                    free_blocks += blocks_for(rr.kv_tokens)
                    self._finish(rr.req, t, finished)

            # 5) if nothing could run, jump to next arrival
            if (plan is None or not plan.requests) and not running:
                if ai < n_total:
                    t = max(t, arrivals[ai].arrival_time)

        return SimResult(total_time=t, finished=finished,
                         preemptions=preemptions, ticks=ticks,
                         padded_prefill_tokens=padded_total,
                         real_prefill_tokens=real_total, busy_time=busy,
                         aborted=aborted)

    def _finish(self, req: Request, t: float, finished: list[Request]) -> None:
        req.state = RequestState.FINISHED
        req.finish_time = t
        finished.append(req)
        self.sched.on_finish(req, t)


def run_comparison(schedulers: dict[str, BaseScheduler],
                   workload: WorkloadSpec | list[Request],
                   cost: CostModel, params: EngineParams | None = None
                   ) -> dict[str, SimResult]:
    """Run the same workload through multiple schedulers (fresh copies of
    the request list each time)."""
    import copy
    base = workload.generate() if isinstance(workload, WorkloadSpec) else workload
    out = {}
    for name, sched in schedulers.items():
        reqs = copy.deepcopy(base)
        sim = ServingSimulator(sched, cost, params)
        out[name] = sim.run(reqs)
    return out
