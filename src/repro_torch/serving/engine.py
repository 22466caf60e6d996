"""Continuous-batching serving engine (PyTorch execution, GPU by default).

The execution model is the JAX engine's legacy path:

  * **slot-based decode** — one decode step over a fixed (max_slots, 1)
    batch; active sequences own slots, and per-slot cache positions let
    sequences of different lengths share the step.  Attention runs through
    the paged-attention kernel over the slot cache viewed as a page pool;
  * **bucketed prefill** — prompts are right-padded to a token-bucket edge
    and prefilled together (flash-attention kernel); EWSJF's homogeneous
    queues keep the padding waste low;
  * **paged accounting** — ``BlockPool`` mirrors vLLM admission/preemption
    (a prompt must fit in free pages; decode growth can preempt LIFO, in
    recompute mode);
  * the **admission policy is pluggable** — any ``core.scheduler``
    ``BaseScheduler`` (FCFS / SJF / EWSJF) drives admission.

Unlike the JAX engine, the decode caches are updated **in place**: prefill
K/V (or an SSM layer's state and conv tail) are copied into the slot
(``_write_slot``) and decode writes each new token's K/V, or the new state,
into its slot row.  For the SSM family (``pad_prompts`` off, as in the JAX
engine) a prefill batch is right-padded to its longest prompt; the port
passes each row's true length into the stack, so a shorter row's state is
that of the row alone (the JAX engine folds its padding into the state).

PyTorch runs eagerly, so the JAX engine's per-shape ``jax.jit`` caches
become plain calls; ``engine_compile_cache_total`` still counts first calls
per shape.

Chunked prefill and engine-side radix prefix reuse are not ported yet
(``chunk_prefill_tokens`` / ``enable_prefix_cache`` raise).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.batch_builder import BatchBudget
from ..core.cost_model import CostModel
from ..core.scheduler import BaseScheduler
from ..core.types import Request, RequestState, TerminalState
from ..models.common import DtypePolicy, resolve_device, rms_norm
from ..models.model import (LMParams, _embed_inputs, _unembed, decode_step,
                            init_decode_caches)
from ..models.transformer import stack_forward
from .kv_cache import BlockPool, SlotAllocator
from .sampler import sample_tokens

_CHUNKED_LATER = ("chunked prefill and engine-side radix prefix reuse are not "
                  "ported yet; they come with the next step of the port "
                  "(chunk_step with a query offset in the flash kernel)")


@dataclass
class EngineConfig:
    """Sizing and feature knobs of one engine (the JAX engine's fields)."""

    max_slots: int = 8
    s_max: int = 512
    block_size: int = 16
    kv_pool_tokens: int = 4096
    buckets: tuple = (32, 64, 128, 256, 512)
    max_prefill_tokens: int = 1024
    temperature: float = 0.0
    time_scale: float = 0.0          # 0 => all arrivals at t=0
    decode_steps_per_tick: int = 4
    pad_prompts: Optional[bool] = None   # None => auto by family
    moe_impl: str = "dropping"
    seed: int = 0
    chunk_prefill_tokens: Optional[int] = None  # not ported: must stay None
    enable_prefix_cache: bool = False           # not ported: must stay False
    prefix_cache_blocks: Optional[int] = None
    engine_id: int = 0


@dataclass
class _SlotState:
    req: Request
    seq_id: int
    budget_left: int


class ServingEngine:
    """Continuous-batching executor over a PyTorch model (module docstring
    for the execution model).  Construct with a model config, parameters
    (``models.init_params`` or ``bridge.params_from_jax``), a
    ``core.scheduler`` policy and an ``EngineConfig``; drive with ``run``
    (batch) or ``add_request`` + ``tick`` (streaming).  ``device`` defaults
    to ``"cuda"`` and raises when no GPU is present.  The optional
    collaborators mirror the cluster planes and are duck-typed:
    ``admission`` (SLO ingress), ``policy_store`` (strategic sync), ``obs``
    (observability)."""

    def __init__(self, cfg: ModelConfig, params: LMParams,
                 scheduler: BaseScheduler,
                 ecfg: EngineConfig | None = None,
                 policy: DtypePolicy | None = None,
                 admission=None, policy_store=None,
                 replica_key: Optional[int] = None,
                 obs=None, cost_model: Optional[CostModel] = None, *,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.sched = scheduler
        self.e = ecfg or EngineConfig()
        if self.e.chunk_prefill_tokens or self.e.enable_prefix_cache:
            raise NotImplementedError(_CHUNKED_LATER)
        self.policy = policy or DtypePolicy(torch.float32, torch.float32,
                                            torch.float32)
        if self.e.pad_prompts is None:
            self.e.pad_prompts = cfg.family not in ("ssm", "hybrid")
        self.pool = BlockPool(self.e.kv_pool_tokens // self.e.block_size,
                              self.e.block_size)
        self.slots = SlotAllocator(self.e.max_slots)
        self.caches = init_decode_caches(cfg, self.e.max_slots, self.e.s_max,
                                         dtype=self.policy.compute,
                                         device=self.device)
        self.slot_pos = np.zeros(self.e.max_slots, dtype=np.int32)
        self.slot_state: dict[int, _SlotState] = {}
        self.last_tokens = np.zeros((self.e.max_slots, 1), dtype=np.int32)
        # Replay/telemetry instrumentation (pure recording — never read by
        # scheduling): dispatch order and wall-clock inter-token gaps.
        self.dispatch_log: list[tuple] = []          # (now, request_id)
        self.decode_gaps: list[float] = []
        self._slot_last_tok = np.full(self.e.max_slots, -1.0)
        self.output_tokens: dict[int, list[int]] = {}  # rid -> sampled ids
        self.admission = admission
        # Observability plane (or None): every emission is guarded, so
        # obs=None costs one attribute check per site.
        self.obs = obs
        # The roofline the attached calibrator scores measured step walls
        # against; auto-created (H100 peaks) when the obs bundle carries one.
        if cost_model is None and obs is not None and \
                getattr(obs, "calib", None) is not None:
            cost_model = CostModel()
        self.cost = cost_model
        if obs is not None and admission is not None:
            admission.obs = obs
            if hasattr(admission, "_classify"):
                obs.classify = admission._classify
        self.policy_store = policy_store
        if replica_key is None and policy_store is not None:
            replica_key = policy_store.issue_party_key()
        self.replica_key = replica_key
        self.shed: list[Request] = []
        self.readmitted = 0
        # Fleet lifecycle flags: a failed engine is never ticked again; a
        # draining one finishes in-flight slots but admits nothing new.
        self.alive = True
        self.draining = False
        self._prefill_tok_rate = 0.0     # EWMA tokens/s, for delay estimates
        self.finished: list[Request] = []
        self.tokens_out = 0
        self.preemptions = 0
        self._decode_seen = False        # first decode tick happened
        self._prefill_shapes: set = set()   # (bucket, n) already run
        self.prefill_batches = 0
        self.padded_tokens = 0
        self.real_tokens = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.e.seed)
        self._t0 = time.monotonic()

    # ---- model steps -------------------------------------------------------

    @torch.no_grad()
    def _prefill_fn(self, tokens: torch.Tensor, true_lens: torch.Tensor):
        """Bucketed prefill returning per-row logits at true_lens-1 (n,1,V)
        f32 and the per-layer caches (attention: (n, bucket, K, hd) K/V;
        SSM: the state and conv tail after each row's last real token)."""
        x = _embed_inputs(self.params, {"tokens": tokens}, self.cfg,
                          self.policy.compute)
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
        h, caches = stack_forward(self.params.blocks, x, self.cfg, positions,
                                  want_cache=True, true_lens=true_lens)
        h = rms_norm(h, self.params.final_norm, self.cfg.norm_eps)
        h_last = h[torch.arange(B, device=x.device), true_lens.long() - 1]
        w = _unembed(self.params, self.cfg)
        logits = (h_last[:, None, :].to(w.dtype) @ w).float()
        return logits, caches

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        return sample_tokens(logits, self._gen,
                             temperature=self.e.temperature).cpu().numpy()

    # ---- time ------------------------------------------------------------

    def now(self) -> float:
        """Engine wall clock: monotonic seconds since construction, scaled
        by ``time_scale`` when set."""
        if self.e.time_scale <= 0:
            return time.monotonic() - self._t0
        return (time.monotonic() - self._t0) * self.e.time_scale

    # ---- main loop ---------------------------------------------------------

    def _est_queue_delay(self, now: float) -> float:
        """Best-effort TTFT-delay estimate from the current backlog and the
        measured prefill token rate (0 until the first batch completes)."""
        if self._prefill_tok_rate <= 0:
            return 0.0
        waiting = self.sched.snapshot(now).waiting_tokens
        return waiting / self._prefill_tok_rate

    def add_request(self, req: Request) -> None:
        """Ingress one request: pass it through the admission controller
        when present (shed / defer / admit) and submit admitted requests to
        the scheduler queue."""
        now = self.now()
        if self.obs is not None:
            self.obs.event("arrival", now, request_id=req.request_id,
                           replica_id=self.e.engine_id)
            self.obs.inc("requests_arrived_total",
                         {"slo_class": self.obs.classify(req)})
        if self.admission is not None:
            dec = self.admission.admit(req, now, self._est_queue_delay(now))
            if not dec.admitted:
                # "defer" parks the request in the controller's bounded
                # re-admission queue; _pump_retries re-offers it.
                if dec.reason != "defer":
                    req.state = RequestState.FAILED
                    req.finish_time = now
                    if req.terminal is None:
                        req.terminal = TerminalState.SHED
                    self.shed.append(req)
                return
        self.sched.submit(req, now=now)
        if self.obs is not None:
            self.obs.event("enqueue", now, request_id=req.request_id,
                           replica_id=self.e.engine_id)

    def _pump_retries(self, now: float) -> None:
        if self.admission is None or not self.admission.retry_pending():
            return
        due, expired = self.admission.due_retries(now)
        self.shed.extend(expired)
        for req in due:
            dec = self.admission.admit(req, now, self._est_queue_delay(now),
                                       retry=True)
            if dec.admitted:
                self.readmitted += 1
                self.sched.submit(req, now=now)
            elif dec.reason != "defer":
                req.state = RequestState.FAILED
                req.finish_time = now
                if req.terminal is None:
                    req.terminal = TerminalState.SHED
                self.shed.append(req)

    def run(self, requests: list[Request], max_steps: int = 100_000) -> list[Request]:
        """Serve every request to completion; returns finished requests."""
        pending = sorted(requests, key=lambda r: r.arrival_time)
        pi = 0
        n_total = len(pending)
        for _ in range(max_steps):
            now = self.now()
            while pi < n_total and pending[pi].arrival_time <= now:
                self.add_request(pending[pi])
                pi += 1
            if len(self.finished) + len(self.shed) >= n_total:
                break
            self._pump_retries(now)
            if hasattr(self.sched, "maybe_reoptimize"):
                self.sched.maybe_reoptimize(now)
            self._maybe_sync_policy(now)
            self._admit(now)
            if (not self.slot_state and self.sched.waiting() == 0
                    and pi < n_total):
                continue
            self._decode_tick()
        return self.finished

    def tick(self) -> None:
        """One engine iteration — the body of ``run``'s loop, for external
        drivers that own arrival ingestion.  A dead engine never ticks; a
        draining one runs its in-flight slots dry but admits nothing new."""
        if not self.alive:
            return
        now = self.now()
        self._pump_retries(now)
        if hasattr(self.sched, "maybe_reoptimize"):
            self.sched.maybe_reoptimize(now)
        self._maybe_sync_policy(now)
        if not self.draining:
            self._admit(now)
        self._decode_tick()
        if self.draining and not self.has_work():
            self.alive = False

    def has_work(self) -> bool:
        """Anything decoding or queued."""
        return bool(self.slot_state or self.sched.waiting())

    # ---- fleet lifecycle (failure / drain) --------------------------------

    def fail(self) -> list[Request]:
        """Hard failure: every in-flight and queued request is orphaned and
        returned for re-routing (recompute recovery — the KV dies with the
        engine)."""
        self.alive = False
        orphans = [st.req for st in self.slot_state.values()]
        orphans += self.sched.drain()
        self.slot_state.clear()
        self.slots = SlotAllocator(self.e.max_slots)
        self._slot_last_tok[:] = -1.0
        self.pool = BlockPool(self.e.kv_pool_tokens // self.e.block_size,
                              self.e.block_size)
        for req in orphans:
            req.state = RequestState.PREEMPTED
            req.preemptions += 1
            req.generated = 0
            req.first_token_time = None
            req.cached_len = 0
            req.prefix_fetch = None
            self.output_tokens.pop(req.request_id, None)
        return orphans

    def start_drain(self) -> list[Request]:
        """Graceful drain: stop admitting, let slots finish (``tick`` flips
        ``alive`` off once the last one does), give queued work back for
        re-routing."""
        self.draining = True
        queued = self.sched.drain()
        for req in queued:
            req.state = RequestState.WAITING
            req.cached_len = 0
            req.prefix_fetch = None
        if not self.has_work():
            self.alive = False
        return queued

    def _maybe_sync_policy(self, now: float) -> None:
        """Strategic-plane round against a shared policy store (publish,
        merge, adopt on the store's cadence).  Never blocks serving."""
        if self.policy_store is not None:
            self.policy_store.sync(self.sched, self.replica_key, now)

    # ---- admission + prefill ----------------------------------------------

    def _admit(self, now: float) -> None:
        free = len(self.slots.free)
        if free == 0 or self.sched.waiting() == 0:
            return
        budget = BatchBudget(max_requests=free,
                             max_tokens=self.e.max_prefill_tokens,
                             kv_blocks_free=self.pool.free_blocks,
                             block_size=self.e.block_size)
        plan = self.sched.tick(now, budget)
        if not plan.requests:
            return
        reqs = [r for r in plan.requests if r.prompt_len <= self.e.s_max - 1]
        if not reqs:
            return
        n = len(reqs)
        max_len = max(r.prompt_len for r in reqs)
        bucket = next((b for b in self.e.buckets if b >= max_len),
                      self.e.buckets[-1])
        if not self.e.pad_prompts:
            bucket = max_len
        tokens = np.zeros((n, bucket), dtype=np.int32)
        lens = np.zeros((n,), dtype=np.int32)
        rng = np.random.default_rng(sum(r.request_id for r in reqs))
        for i, r in enumerate(reqs):
            if r.prompt_tokens is None:
                r.prompt_tokens = rng.integers(
                    0, self.cfg.vocab_size, size=(r.prompt_len,)
                ).astype(np.int32)
            tokens[i, : r.prompt_len] = r.prompt_tokens
            lens[i] = r.prompt_len
        self.prefill_batches += 1
        self.padded_tokens += bucket * n
        self.real_tokens += int(lens.sum())
        fresh = (bucket, n) not in self._prefill_shapes
        self._prefill_shapes.add((bucket, n))
        t_pf0 = self.now()
        logits, caches = self._prefill_fn(
            torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(lens).to(self.device))
        first = self._sample(logits)
        t_first = self.now()
        # The observed prefill rate feeds the admission delay estimator;
        # first calls per shape are skipped, as the JAX engine skips its
        # compiling calls.
        if not fresh:
            rate = int(lens.sum()) / max(t_first - t_pf0, 1e-6)
            self._prefill_tok_rate = (rate if self._prefill_tok_rate <= 0 else
                                      0.7 * self._prefill_tok_rate + 0.3 * rate)
        if self.obs is not None:
            self.obs.event("prefill", t_pf0, dur=max(t_first - t_pf0, 0.0),
                           replica_id=self.e.engine_id,
                           data={"batch": n, "bucket": bucket,
                                 "tokens": int(lens.sum())})
            self.obs.inc("engine_compile_cache_total",
                         {"kind": "prefill",
                          "hit": "false" if fresh else "true"})
            if self.cost is not None and not fresh:
                self.obs.calibrate(
                    "prefill_chunk",
                    self.cost.prefill_step_time(int(lens.sum()),
                                                float(lens.mean())),
                    max(t_first - t_pf0, 1e-9))
        for i, r in enumerate(reqs):
            self.pool.allocate(r.request_id, r.prompt_len)
            slot = self.slots.acquire(r.request_id)
            if slot is None:       # budget.max_requests == free slots
                raise RuntimeError("scheduler admitted more requests than "
                                   "free slots")
            self._write_slot(slot, caches, i)
            r.state = RequestState.RUNNING_DECODE
            r.first_token_time = t_first
            self.dispatch_log.append((t_pf0, r.request_id))
            self._slot_last_tok[slot] = t_first
            if self.obs is not None:
                wait = max(0.0, t_pf0 - r.arrival_time)
                self.obs.event("dispatch", t_pf0, request_id=r.request_id,
                               replica_id=self.e.engine_id,
                               data={"wait": round(wait, 6)})
                self.obs.observe("sched_dispatch_wait_seconds", wait,
                                 {"slo_class": self.obs.classify(r)})
                self.obs.event("first_token", t_first,
                               request_id=r.request_id,
                               replica_id=self.e.engine_id)
            r.generated = 1
            self.tokens_out += 1
            self.output_tokens[r.request_id] = [int(first[i, 0])]
            self.slot_pos[slot] = r.prompt_len
            self.last_tokens[slot, 0] = first[i, 0]
            self.slot_state[slot] = _SlotState(
                req=r, seq_id=r.request_id,
                budget_left=r.max_new_tokens - 1)
            if r.max_new_tokens <= 1:
                self._finish_slot(slot)

    def _write_slot(self, slot: int, prefill_caches: list, row: int) -> None:
        """Copy row ``row`` of the per-layer prefill caches into the decode
        slot **in place**.  K/V fill the slot's first bucket positions and
        zero the rest (the JAX engine writes a zero-padded row); SSM state
        and conv entries have no sequence axis and are copied whole."""
        for dst, src in zip(self.caches, prefill_caches):
            for name, t in src.items():
                if name in ("k", "v"):
                    S = t.shape[1]
                    dst[name][slot, :S].copy_(t[row])
                    dst[name][slot, S:].zero_()
                else:
                    dst[name][slot].copy_(t[row])

    # ---- decode -------------------------------------------------------------

    def _decode_tick(self) -> None:
        if not self.slot_state:
            return
        t_tick0 = self.now()
        steps = 0
        # Tick-start batch composition, for the decode calibration sample.
        batch0 = len(self.slot_state)
        kv0 = int(sum(int(self.slot_pos[s]) for s in self.slot_state))
        for _ in range(self.e.decode_steps_per_tick):
            if not self.slot_state:
                break
            # paged growth accounting (+ LIFO recompute preemption)
            for slot in sorted(self.slot_state, reverse=True):
                st = self.slot_state[slot]
                if not self.pool.grow(st.seq_id, int(self.slot_pos[slot]) + 1):
                    if len(self.slot_state) > 1:
                        self._preempt_slot(slot)
                    # else: single sequence — let it run (pool undersized)
            toks = torch.from_numpy(self.last_tokens).to(self.device)
            logits, self.caches = decode_step(self.params, toks, self.caches,
                                              self.slot_pos, self.cfg,
                                              policy=self.policy)
            nxt = self._sample(logits)
            t = self.now()
            steps += 1
            done = []
            for slot, st in self.slot_state.items():
                self.slot_pos[slot] += 1
                self.last_tokens[slot, 0] = nxt[slot, 0]
                self.tokens_out += 1
                self.output_tokens.setdefault(
                    st.req.request_id, []).append(int(nxt[slot, 0]))
                st.req.generated += 1
                st.budget_left -= 1
                if self._slot_last_tok[slot] >= 0:
                    self.decode_gaps.append(t - self._slot_last_tok[slot])
                self._slot_last_tok[slot] = t
                if st.budget_left <= 0 or self.slot_pos[slot] >= self.e.s_max - 1:
                    done.append(slot)
            for slot in done:
                self._finish_slot(slot)
        if self.obs is not None and steps:
            t_end = self.now()
            self.obs.event("decode", t_tick0, dur=max(t_end - t_tick0, 0.0),
                           replica_id=self.e.engine_id,
                           data={"batch": batch0, "steps": steps})
            self.obs.gauge("kv_occupancy", v=self.pool.utilization)
            self.obs.gauge("engine_slots_active",
                           v=float(len(self.slot_state)))
            self.obs.inc("engine_compile_cache_total",
                         {"kind": "decode",
                          "hit": "true" if self._decode_seen else "false"})
            if self.cost is not None and self._decode_seen and batch0 > 0:
                self.obs.calibrate(
                    "decode_step",
                    self.cost.decode_step_time(batch0, kv0),
                    max((t_end - t_tick0) / steps, 1e-9))
        if steps:
            self._decode_seen = True

    def _preempt_slot(self, slot: int, cause: str = "kv_pressure") -> None:
        st = self.slot_state.pop(slot)
        self.pool.free(st.seq_id)
        self.slots.release(slot)
        self._slot_last_tok[slot] = -1.0
        req = st.req
        req.state = RequestState.PREEMPTED
        req.preemptions += 1
        req.generated = 0
        req.first_token_time = None
        self.output_tokens.pop(req.request_id, None)   # recompute restarts
        self.preemptions += 1
        self.sched.submit(req, now=self.now())
        if self.obs is not None:
            self.obs.event("preempt", self.now(),
                           request_id=req.request_id,
                           replica_id=self.e.engine_id,
                           data={"slot": slot, "cause": cause})
            self.obs.inc("preemptions_total", {"kind": cause})

    def _finish_slot(self, slot: int) -> None:
        st = self.slot_state.pop(slot, None)
        if st is None:
            return
        req = st.req
        self.pool.free(st.seq_id)
        self.slots.release(slot)
        self._slot_last_tok[slot] = -1.0
        req.state = RequestState.FINISHED
        req.finish_time = self.now()
        req.terminal = TerminalState.FINISHED
        self.finished.append(req)
        self.sched.on_finish(req, req.finish_time)
        if self.obs is not None:
            self.obs.finish(req, req.finish_time,
                            replica_id=self.e.engine_id)

    # ---- stats ---------------------------------------------------------------

    def slo_report(self, classify=None) -> dict:
        """Per-class TTFT/TBT/E2E percentiles of the finished requests: the
        live registry when an obs bundle is wired, an identical
        recomputation from ``self.finished`` otherwise."""
        from ..obs.slo import slo_or_fallback
        metrics = self.obs.metrics if self.obs is not None else None
        return slo_or_fallback(metrics, self.finished, classify)

    def heartbeat(self) -> dict:
        """Liveness and load beacon for fleet health monitoring: identity,
        clock, KV/slot occupancy, backlog and progress counters."""
        hb = {
            "engine_id": self.e.engine_id,
            "t": self.now(),
            "kv_occupancy": self.pool.utilization,
            "slots_active": len(self.slot_state),
            "prefilling": 0,           # no chunked prefill in this engine
            "waiting": self.sched.waiting(),
            "finished": len(self.finished),
            "tokens_out": self.tokens_out,
        }
        if self.obs is not None and self.obs.metrics is not None:
            hb["metrics"] = self.obs.metrics.snapshot()
        return hb

    def stats(self) -> dict:
        """Run summary: throughput, terminal accounting, padding waste and
        the decode inter-token-gap (TBT) percentiles."""
        elapsed = self.now()
        toks = sum(r.generated for r in self.finished)
        terminal: dict[str, int] = {}
        for r in self.finished + self.shed:
            if r.terminal is not None:
                terminal[r.terminal.value] = terminal.get(
                    r.terminal.value, 0) + 1
        return {
            "finished": len(self.finished),
            "shed": len(self.shed),
            "terminal": terminal,
            "slo": self.slo_report(),
            "readmitted": self.readmitted,
            "admission": (self.admission.stats()
                          if self.admission is not None else {}),
            "elapsed_s": elapsed,
            "tok_per_s": toks / max(elapsed, 1e-9),
            "req_per_s": len(self.finished) / max(elapsed, 1e-9),
            "preemptions": self.preemptions,
            "prefill_batches": self.prefill_batches,
            "padding_waste": (1.0 - self.real_tokens
                              / max(self.padded_tokens, 1)),
            "decode_tbt_p95": (float(np.percentile(self.decode_gaps, 95))
                               if self.decode_gaps else 0.0),
            "decode_tbt_max": (float(max(self.decode_gaps))
                               if self.decode_gaps else 0.0),
        }
