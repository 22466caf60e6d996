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
into its slot row.  For the SSM and hybrid (RG-LRU) families
(``pad_prompts`` off, as in the JAX engine) a prefill batch is
right-padded to its longest prompt; the port passes each row's true
length into the stack, so a shorter row's state, conv tail and ring are
those of the row alone (the JAX engine folds its padding into them).

PyTorch runs eagerly, so the JAX engine's per-shape ``jax.jit`` caches
become plain calls; ``engine_compile_cache_total`` still counts first calls
per shape (prefill shapes, chunk widths).

Two opt-in features follow the JAX engine (``docs/ENGINE.md``):

* **chunked prefill** (``chunk_prefill_tokens``) — prompts prefill in
  budgeted chunks through ``models.chunk_step`` on the slot's own cache
  rows (in place, flash kernel with a query offset), interleaved with
  ``_decode_tick``, so a long prompt no longer stalls every decoding
  sequence for its whole prefill.  A slot in mid-prefill parks its decode
  cursor at ``s_max - 1``: the global decode step writes only there;
* **engine-side radix prefix reuse** (``enable_prefix_cache``) — a
  ``kvplane.RadixPrefixIndex`` runs against the engine's own ``BlockPool``;
  prefills match their chained block hashes, copy the cached prefix KV
  into the slot, and prefill only the uncached suffix at its offset
  through the same chunked path.  The cached KV lives on the **host**, as
  in the JAX engine (export and import hand host blocks between engines):
  for each run of blocks published together, one pinned tensor per layer
  that holds a slab of rows for each of the layer's sequence-axis cache
  entries (GQA's ``"k"`` and ``"v"``, MLA's latent ``"ckv"``), as the JAX
  engine's tree-map takes whatever its cache holds.

Both raise ``ValueError`` for a family ``supports_chunked_decode`` rejects
(the SSM family, stacks with sliding-window layers: h2o-danube, gemma3,
recurrentgemma, and models fed embeddings: internvl2), as the JAX engine
does; GQA and MLA stacks without a ring run both.  Both off ⇒ the bucketed
path.  A model fed embeddings (internvl2) is served as the JAX engine
serves it: the prompt tokens go through the embedding table and into the
prefill as ``{"embeddings"}``, and decode takes tokens.  An encoder-only
model (hubert) has no decode and no embedding table, so the engine refuses
it at construction with a ``ValueError`` (the JAX engine cannot serve one
either: its prefill reads the table).
An MoE config runs its experts by ``EngineConfig.moe_impl`` (``dropping``,
as in the JAX engine, or ``dense``) in every prefill and decode step.

Two faults of the JAX engine are not copied.  A planned request whose
prompt cannot fit a slot (``prompt_len > s_max - 1``) is shed with
``TerminalState.SHED`` instead of being dropped without a terminal state
(which leaves the JAX engine's ``run`` spinning to ``max_steps``).  And a
sliding-window layer's ring cache is built from each row's true length
(``attention.ring_cache_from_prefill``): the JAX engine keeps the last W
positions of the bucket, so a row shorter than a bucket longer than the
window decodes from pads and loses real positions still in its window.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.batch_builder import BatchBudget
from ..core.cost_model import CostModel
from ..core.scheduler import BaseScheduler
from ..core.types import Request, RequestState, TerminalState

if TYPE_CHECKING:   # runtime import is deferred: kvplane.radix imports
    from ..kvplane.radix import RadixPrefixIndex   # serving.kv_cache, and a
                                                   # module-level import here
                                                   # would close the cycle
from ..models.common import DtypePolicy, resolve_device, rms_norm
from ..models.model import (LMParams, _embed_inputs, _unembed, chunk_step,
                            decode_step, init_decode_caches)
from ..models.transformer import (SEQ_CACHE_ENTRIES, stack_forward,
                                  supports_chunked_decode)
from .kv_cache import BlockPool, SlotAllocator
from .sampler import sample_tokens


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
    chunk_prefill_tokens: Optional[int] = None  # per-tick chunk budget; None=off
    enable_prefix_cache: bool = False           # engine-side radix KV reuse
    prefix_cache_blocks: Optional[int] = None   # radix pool-share cap (None=all)
    engine_id: int = 0


@dataclass
class _SlotState:
    req: Request
    seq_id: int
    budget_left: int
    pin_node: object = None         # pinned radix path (prefix-cache mode)
    cap_tokens: int = 0             # KV token capacity allocated (chunked mode)


@dataclass
class _PrefillState:
    """A slot mid-chunked-prefill: admitted, holding pool blocks and its
    pinned prefix path, cursor at ``pos`` prompt tokens resident."""

    req: Request
    seq_id: int
    pos: int                        # prompt tokens already in the slot cache
    pin_node: object = None
    cap_tokens: int = 0


def _runs(idxs: list) -> list:
    """Split ascending block indices into runs of consecutive ones."""
    out: list = []
    for i in idxs:
        if out and out[-1][-1] == i - 1:
            out[-1].append(i)
        else:
            out.append([i])
    return out


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
        if cfg.is_encoder_only:
            raise ValueError(f"{cfg.name} is encoder-only: it has no decode "
                             f"step to serve (run models.prefill for its "
                             f"per-position logits)")
        # Chunked-prefill / prefix-reuse mode: every admission goes through
        # the per-slot chunk path (suffix prefill at an offset needs it).
        self._chunked = (bool(self.e.chunk_prefill_tokens)
                         or self.e.enable_prefix_cache)
        if self._chunked and not supports_chunked_decode(cfg):
            raise ValueError(
                f"chunked prefill / prefix cache unsupported for family "
                f"{cfg.family!r} (ring/recurrent/encoder-only stacks)")
        self._chunk_budget = (self.e.chunk_prefill_tokens
                              or self.e.max_prefill_tokens)
        self.policy = policy or DtypePolicy(torch.float32, torch.float32,
                                            torch.float32)
        if self.e.pad_prompts is None:
            self.e.pad_prompts = cfg.family not in ("ssm", "hybrid")
        self.pool = BlockPool(self.e.kv_pool_tokens // self.e.block_size,
                              self.e.block_size)
        self.slots = SlotAllocator(self.e.max_slots)
        self.radix: Optional[RadixPrefixIndex] = None
        # radix node_id -> (run, i): block i of a run of n blocks published
        # together; a run is, per layer, a dict of (n·block_size, ...) host
        # slabs, one per sequence-axis cache entry, all views of one pinned
        # tensor.  A run's host memory is released when its last node
        # leaves the tree.
        self._node_kv: dict[int, tuple] = {}
        self._new_radix()
        self._prefilling: dict[int, _PrefillState] = {}  # admission order
        self._chunk_widths: set = set()      # chunk widths already run
        self.chunks_run = 0
        self.chunk_tokens = 0
        self.prefix_saved_tokens = 0
        self.interleaved_ticks = 0   # decode ticks run while a prefill was up
        # Host-side radix KV copies: device-to-host when a prefill publishes
        # its blocks, host-to-device when a prefix attaches (seconds, bytes,
        # blocks).  Pure recording.
        self.radix_copies = {"d2h_s": 0.0, "d2h_bytes": 0, "d2h_blocks": 0,
                             "host_alloc_s": 0.0,
                             "h2d_s": 0.0, "h2d_bytes": 0, "h2d_blocks": 0}
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

    def _new_radix(self) -> None:
        """A fresh radix index over the current pool (prefix-cache mode)."""
        if not self.e.enable_prefix_cache:
            return
        from ..kvplane.radix import RadixPrefixIndex
        self.radix = RadixPrefixIndex(
            self.pool, self.e.block_size,
            capacity_blocks=self.e.prefix_cache_blocks)
        self.radix.on_evict = self._on_radix_evict

    # ---- model steps -------------------------------------------------------

    @torch.no_grad()
    def _prefill_fn(self, tokens: torch.Tensor, true_lens: torch.Tensor):
        """Bucketed prefill returning per-row logits at true_lens-1 (n,1,V)
        f32 and the per-layer caches (attention: (n, bucket, K, hd) K/V or
        MLA's (n, bucket, 1, r+rd) latent rows; SSM: the state and conv
        tail after each row's last real token).  A model fed embeddings
        gets the prompt tokens' rows of its table, as the JAX engine's
        prefill does."""
        batch = ({"tokens": tokens} if self.cfg.input_mode == "tokens" else
                 {"embeddings": self.params.embed[tokens.long()]
                  .to(self.policy.compute)})
        x = _embed_inputs(self.params, batch, self.cfg, self.policy.compute)
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
        h, caches = stack_forward(self.params.blocks, x, self.cfg, positions,
                                  want_cache=True, true_lens=true_lens,
                                  moe_impl=self.e.moe_impl)
        h = rms_norm(h, self.params.final_norm, self.cfg.norm_eps)
        h_last = h[torch.arange(B, device=x.device), true_lens.long() - 1]
        w = _unembed(self.params, self.cfg)
        logits = (h_last[:, None, :].to(w.dtype) @ w).float()
        return logits, caches

    def _slot_view(self, slot: int) -> list:
        """One slot's caches as B=1 views (``chunk_step`` writes through
        them into the engine caches)."""
        return [{name: t[slot:slot + 1] for name, t in layer.items()}
                for layer in self.caches]

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

    def _stamp_prefix(self, req: Request) -> None:
        """Chunked/prefix mode: materialize prompt tokens up front (the
        chunk cursor needs them before dispatch), hash them, and stamp the
        queue-side ``cached_len`` *estimate* from a read-only radix probe,
        so EWSJF queues and scores the request on its effective length.  The
        authoritative resolution happens at dispatch (``_attach_prefix``)."""
        if req.prompt_tokens is None:
            rng = np.random.default_rng(req.request_id)
            req.prompt_tokens = rng.integers(
                0, self.cfg.vocab_size, size=(req.prompt_len,)).astype(np.int32)
        else:
            req.prompt_tokens = np.asarray(req.prompt_tokens, dtype=np.int32)
        if self.radix is None:
            return
        if req.prompt_hashes is None:
            from ..kvplane.radix import chain_block_hashes
            req.prompt_hashes = chain_block_hashes(req.prompt_tokens.tolist(),
                                                   self.e.block_size)
        blocks = self.radix.match(req.prompt_hashes, touch=False).blocks
        req.cached_len = min(blocks * self.e.block_size,
                             int(req.prompt_len) - 1)
        if self.obs is not None:
            self.obs.event("probe", self.now(), request_id=req.request_id,
                           replica_id=self.e.engine_id,
                           data={"blocks": blocks,
                                 "cached_est": int(req.cached_len)})
            self.obs.inc("radix_probe_total",
                         {"hit": "true" if blocks else "false"})

    def add_request(self, req: Request) -> None:
        """Ingress one request: stamp its prefix estimate (chunked/prefix
        mode), pass it through the admission controller when present (shed
        / defer / admit) and submit admitted requests to the scheduler
        queue."""
        now = self.now()
        if self._chunked:
            self._stamp_prefix(req)
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
            self._prefill_chunk_tick(now)
            if (not self.slot_state and not self._prefilling
                    and self.sched.waiting() == 0 and pi < n_total):
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
        self._prefill_chunk_tick(now)
        self._decode_tick()
        if self.draining and not self.has_work():
            self.alive = False

    def has_work(self) -> bool:
        """Anything decoding, mid-prefill, or queued."""
        return bool(self.slot_state or self._prefilling
                    or self.sched.waiting())

    # ---- fleet lifecycle (failure / drain) --------------------------------

    def fail(self) -> list[Request]:
        """Hard failure: every in-flight and queued request is orphaned and
        returned for re-routing (recompute recovery — the KV, the radix
        cache and the host block store die with the engine)."""
        self.alive = False
        orphans = [st.req for st in self._prefilling.values()]
        orphans += [st.req for st in self.slot_state.values()]
        orphans += self.sched.drain()
        self._prefilling.clear()
        self.slot_state.clear()
        self.slots = SlotAllocator(self.e.max_slots)
        self._slot_last_tok[:] = -1.0
        self.pool = BlockPool(self.e.kv_pool_tokens // self.e.block_size,
                              self.e.block_size)
        self._node_kv.clear()
        self._new_radix()
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

    # ---- host-KV handoff (fleet prefix plane) -----------------------------

    def export_prefix_blocks(self, hashes, want: int) -> list:
        """Source side of a host-KV handoff: the host KV blocks of the
        longest locally cached prefix of ``hashes``, root first, capped at
        ``want`` blocks and cut at the first block whose KV is not
        host-resident (so the shipped set is a closed prefix an importer can
        attach).  Each block is a per-layer list of host tensors of the
        layer's sequence-axis cache entries, block_size rows each (``{"k",
        "v"}`` of (block_size, K, hd), or MLA's ``{"ckv"}`` of (block_size,
        1, r + rd)); ``bridge.caches_to_numpy`` gives the JAX engine's
        layout."""
        if self.radix is None or not hashes or want <= 0:
            return []
        m = self.radix.match(hashes[:want], self.now())
        out: list = []
        for nd in self._path(m.node):
            if nd.node_id not in self._node_kv:
                break
            out.append(self._block_kv(nd.node_id))
        return out

    def import_prefix_blocks(self, hashes, blocks_kv: list) -> int:
        """Destination side of a host-KV handoff: insert the chain into the
        local radix (allocating real pool blocks — the pool stays the single
        accountant) and attach the shipped host KV (per-layer lists in the
        layout :meth:`export_prefix_blocks` gives; ``bridge.caches_from_jax``
        converts the JAX engine's) to the newly resident nodes.  Pool
        pressure may stop the insert early; only blocks that landed count.
        Returns blocks landed."""
        if self.radix is None or not blocks_kv:
            return 0
        node, _ = self.radix.insert(hashes[:len(blocks_kv)], self.now())
        path = self._path(node)[:len(blocks_kv)]
        bs = self.e.block_size
        missing = [i for i, nd in enumerate(path)
                   if nd.node_id not in self._node_kv]
        for run in _runs(missing):
            host = self._new_run(len(run))
            for j, i in enumerate(run):
                for slabs, layer in zip(host, blocks_kv[i]):
                    for name, slab in slabs.items():
                        slab[j * bs:(j + 1) * bs].copy_(layer[name])
                self._node_kv[path[i].node_id] = (host, j)
        return len(path)

    @staticmethod
    def _path(node) -> list:
        """Radix nodes from the root's child down to ``node``."""
        path: list = []
        while node is not None and node.depth > 0:
            path.append(node)
            node = node.parent
        path.reverse()
        return path

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
        reqs = self._shed_oversized(plan.requests, now)
        if self._chunked:
            self._admit_chunked(reqs, now)
            return
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

    def _shed_oversized(self, reqs: list, now: float) -> list:
        """Shed every planned request whose prompt cannot fit a slot
        (``prompt_len > s_max - 1``) with ``TerminalState.SHED``; return the
        rest.  The scheduler has already popped them, so dropping them
        silently (as the JAX engine does) would leave them without a
        terminal state and ``run`` spinning to ``max_steps``."""
        keep = []
        for r in reqs:
            if r.prompt_len <= self.e.s_max - 1:
                keep.append(r)
                continue
            r.state = RequestState.FAILED
            r.finish_time = now
            r.terminal = TerminalState.SHED
            self.shed.append(r)
            if self.obs is not None:
                self.obs.inc("requests_terminal_total",
                             {"state": TerminalState.SHED.value,
                              "slo_class": self.obs.classify(r)})
                self.obs.event("shed", now, request_id=r.request_id,
                               replica_id=self.e.engine_id,
                               data={"why": "prompt_exceeds_slot",
                                     "prompt_len": int(r.prompt_len)})
        return keep

    def _write_slot(self, slot: int, prefill_caches: list, row: int) -> None:
        """Copy row ``row`` of the per-layer prefill caches into the decode
        slot **in place**.  An entry with a sequence axis (GQA's K/V, MLA's
        latent rows) fills the slot's first bucket positions and zeroes the
        rest (the JAX engine writes a zero-padded row).  A ring of a
        sliding-window layer comes from the prefill with min(window,
        bucket) slots: a whole ring of the slot's W′ = min(window, s_max)
        when the bucket is longer than the window, copied whole; else the
        bucket's positions at their own slots, the rest zeroed as above.
        SSM and RG-LRU state and conv entries (``h`` in f32) have no
        sequence axis and are copied whole."""
        for dst, src in zip(self.caches, prefill_caches):
            for name, t in src.items():
                if name in SEQ_CACHE_ENTRIES:
                    S = t.shape[1]
                    dst[name][slot, :S].copy_(t[row])
                    dst[name][slot, S:].zero_()
                else:
                    dst[name][slot].copy_(t[row])

    # ---- host KV store (prefix-cache mode) ----------------------------------

    def _new_run(self, n: int) -> list:
        """Host buffers for ``n`` blocks, pinned on a GPU engine: per layer,
        one tensor in the cache dtype cut into an (n·block_size, ...) slab
        for each sequence-axis cache entry (GQA: ``"k"`` then ``"v"``; MLA:
        ``"ckv"``).  Returns the per-layer dicts of slabs."""
        rows = n * self.e.block_size
        run = []
        for c in self.caches:
            entries = {name: t for name, t in c.items()
                       if name in SEQ_CACHE_ENTRIES}
            sizes = [rows * t[0, 0].numel() for t in entries.values()]
            dtype = next(iter(entries.values())).dtype
            flat = torch.empty(sum(sizes), dtype=dtype,
                               pin_memory=self.device.type == "cuda")
            run.append({name: part.view((rows,) + tuple(t.shape[2:]))
                        for (name, t), part in zip(entries.items(),
                                                   flat.split(sizes))})
        return run

    def _sync(self) -> None:
        """Wait for the device's queued work, so that a host-timed copy
        measures the copy alone (the copies themselves are synchronous)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _block_bytes(self) -> int:
        """Host bytes of one block: block_size rows of every sequence-axis
        cache entry of every layer (GQA 2·K·hd, MLA r + rd elements a row)."""
        bs = self.e.block_size
        return sum(bs * t[0, 0].numel() * t.element_size()
                   for c in self.caches for name, t in c.items()
                   if name in SEQ_CACHE_ENTRIES)

    def _publish_blocks(self, slot: int, path: list) -> None:
        """Copy the slot's rows of every block on ``path`` whose KV is not
        host-resident yet into the host store (device to host, one copy per
        layer and cache entry for each run of consecutive blocks).
        Allocating (pinning) the host buffers and copying are timed
        apart."""
        missing = [i for i, nd in enumerate(path)
                   if nd.node_id not in self._node_kv]
        if not missing:
            return
        bs = self.e.block_size
        self._sync()
        for run in _runs(missing):
            t0 = time.monotonic()
            host = self._new_run(len(run))
            t1 = time.monotonic()
            lo, hi = run[0] * bs, (run[-1] + 1) * bs
            for slabs, c in zip(host, self.caches):
                for name, slab in slabs.items():
                    slab.copy_(c[name][slot, lo:hi])
            for j, i in enumerate(run):
                self._node_kv[path[i].node_id] = (host, j)
            self.radix_copies["host_alloc_s"] += t1 - t0
            self.radix_copies["d2h_s"] += time.monotonic() - t1
        self.radix_copies["d2h_blocks"] += len(missing)
        self.radix_copies["d2h_bytes"] += len(missing) * self._block_bytes()

    def _write_blocks(self, slot: int, path: list) -> None:
        """Copy the host KV of the blocks on ``path`` into the slot's first
        ``len(path)`` blocks — the radix attach: cached prefix blocks land
        without recompute (host to device, one copy per layer and cache
        entry for each stretch of blocks that are consecutive in one
        run)."""
        bs = self.e.block_size
        groups: list = []                # [host, first j, first i, n]
        for i, nd in enumerate(path):
            host, j = self._node_kv[nd.node_id]
            g = groups[-1] if groups else None
            if g is not None and g[0] is host and g[1] + g[3] == j:
                g[3] += 1
            else:
                groups.append([host, j, i, 1])
        for host, j, i, n in groups:
            for slabs, c in zip(host, self.caches):
                for name, slab in slabs.items():
                    c[name][slot, i * bs:(i + n) * bs].copy_(
                        slab[j * bs:(j + n) * bs])

    def _block_kv(self, node_id: int) -> list:
        """A host-resident block as the port's per-layer list of dicts of
        its cache entries' block_size rows (views of its run)."""
        host, j = self._node_kv[node_id]
        bs = self.e.block_size
        return [{name: slab[j * bs:(j + 1) * bs]
                 for name, slab in slabs.items()} for slabs in host]

    # ---- chunked admission + prefill ------------------------------------------

    def _on_radix_evict(self, node_id: int) -> None:
        """Radix eviction hook: drop the node's host-side KV block and
        record the eviction."""
        self._node_kv.pop(node_id, None)
        if self.obs is not None:
            self.obs.event("evict", self.now(),
                           replica_id=self.e.engine_id,
                           data={"node": node_id})
            self.obs.inc("radix_evict_total")

    def _attach_prefix(self, r: Request, slot: int, now: float
                       ) -> tuple[int, int, object]:
        """Authoritative prefix resolution for one dispatched request: match
        the radix, copy every matched block whose KV is host-resident into
        the slot caches, then insert + pin the request's *full* prompt path
        (blocks computed this pass are about to exist; their content is
        published when the prefill completes).  Returns ``(cached_tokens,
        resident_blocks, pin_node)``."""
        if self.radix is None or not r.prompt_hashes:
            r.cached_len = 0
            return 0, 0, None
        bs = self.e.block_size
        hashes = r.prompt_hashes
        path = self._path(self.radix.match(hashes, now).node)
        # Usable = contiguous matched blocks with host KV content, capped so
        # at least one suffix token remains to produce the first logit.
        max_blocks = (int(r.prompt_len) - 1) // bs
        usable = 0
        for nd in path[:max_blocks]:
            if nd.node_id not in self._node_kv:
                break
            usable += 1
        full_blocks = int(r.prompt_len) // bs
        pin_node, _ = self.radix.insert(hashes[:full_blocks], now)
        self.radix.pin(pin_node)
        resident = pin_node.depth if pin_node is not None else 0
        if usable:
            self._sync()
        t_a0 = self.now()
        self._write_blocks(slot, path[:usable])
        t_a1 = self.now()
        cached_tokens = usable * bs
        r.cached_len = cached_tokens
        self.prefix_saved_tokens += cached_tokens
        copied = self._block_bytes() * usable
        if usable:
            self.radix_copies["h2d_s"] += t_a1 - t_a0
            self.radix_copies["h2d_blocks"] += usable
            self.radix_copies["h2d_bytes"] += copied
        if self.obs is not None:
            self.obs.inc("radix_insert_total")
            if usable:
                self.obs.event("attach", t_a0, request_id=r.request_id,
                               replica_id=self.e.engine_id,
                               dur=max(t_a1 - t_a0, 0.0),
                               data={"slot": slot, "blocks": usable,
                                     "tokens": cached_tokens,
                                     "bytes": int(copied)})
                self.obs.observe("radix_attach_copy_bytes", float(copied))
                if self.cost is not None:
                    self.obs.calibrate(
                        "attach_copy",
                        self.cost.attach_copy_time(cached_tokens),
                        max(t_a1 - t_a0, 1e-9))
        return cached_tokens, resident, pin_node

    def _admit_chunked(self, reqs: list, now: float) -> None:
        """Admit dispatched requests into slots as chunk-prefill jobs: take
        a slot, resolve + attach the cached prefix, allocate the private
        (uncached) KV up front, and park the request in ``_prefilling`` —
        ``_prefill_chunk_tick`` then advances cursors under the chunk
        budget, interleaved with decode."""
        bs = self.e.block_size
        for r in reqs:
            slot = self.slots.acquire(r.request_id)
            if slot is None:       # budget.max_requests == free slots
                raise RuntimeError("scheduler admitted more requests than "
                                   "free slots")
            r.state = RequestState.RUNNING_PREFILL
            # Park the slot's decode cursor at the scratch position: the
            # global decode step runs over *all* slot rows, and its cache
            # write for this row must not land inside the prompt span being
            # chunk-prefilled.  s_max-1 is causally masked for every live
            # sequence until its own final step overwrites it.
            self.slot_pos[slot] = self.e.s_max - 1
            self.last_tokens[slot, 0] = 0
            cached, resident, pin_node = self._attach_prefix(r, slot, now)
            # Private allocation = prompt KV minus radix-resident blocks
            # (unchecked — admission was guarded on the *estimate*;
            # transient overdraw is reclaimed by decode-time preemption).
            private = max(int(r.prompt_len) - resident * bs, 0)
            self.pool.allocate_unchecked(r.request_id, private)
            cap = resident * bs + self.pool.blocks_for(private) * bs
            self._prefilling[slot] = _PrefillState(
                req=r, seq_id=r.request_id, pos=cached,
                pin_node=pin_node, cap_tokens=cap)
            self.dispatch_log.append((now, r.request_id))
            if self.obs is not None:
                wait = max(0.0, now - r.arrival_time)
                self.obs.event("dispatch", now, request_id=r.request_id,
                               replica_id=self.e.engine_id,
                               data={"wait": round(wait, 6),
                                     "cached_tokens": cached})
                self.obs.event("park", now, request_id=r.request_id,
                               replica_id=self.e.engine_id,
                               data={"slot": slot, "cap_tokens": cap})
                self.obs.observe("sched_dispatch_wait_seconds", wait,
                                 {"slo_class": self.obs.classify(r)})

    def _prefill_chunk_tick(self, now: float) -> None:
        """Advance every in-flight chunked prefill under the per-tick token
        budget (admission order — FIFO across slots), promoting completed
        prompts to decode.  One tick spends at most ``chunk_prefill_tokens``
        (or ``max_prefill_tokens`` in pure prefix-reuse mode) prefill
        tokens, so decoding sequences wait at most one chunk per tick."""
        if not self._prefilling:
            return
        left = self._chunk_budget
        completed: list[tuple[int, torch.Tensor]] = []
        for slot in list(self._prefilling):
            if left <= 0:
                break
            st = self._prefilling[slot]
            r = st.req
            pos0 = st.pos
            width = min(int(r.prompt_len) - st.pos, left)
            left -= width
            toks = torch.from_numpy(np.asarray(
                r.prompt_tokens[st.pos:st.pos + width],
                dtype=np.int32)[None]).to(self.device)
            fresh = width not in self._chunk_widths
            self._chunk_widths.add(width)
            t0 = self.now()
            logits, _ = chunk_step(self.params, toks, self._slot_view(slot),
                                   st.pos, self.cfg, policy=self.policy,
                                   moe_impl=self.e.moe_impl)
            st.pos += width
            t1 = self.now()
            self.chunks_run += 1
            self.chunk_tokens += width
            self.real_tokens += width
            self.padded_tokens += width      # chunk path pads nothing
            if not fresh:
                rate = width / max(t1 - t0, 1e-6)
                self._prefill_tok_rate = (
                    rate if self._prefill_tok_rate <= 0 else
                    0.7 * self._prefill_tok_rate + 0.3 * rate)
            if self.obs is not None:
                # A chunk re-running a preempted request's prompt is a
                # "recompute" span; first-pass chunks are "chunk".
                kind = "recompute" if r.preemptions > 0 else "chunk"
                self.obs.event(kind, t0, request_id=r.request_id,
                               replica_id=self.e.engine_id,
                               dur=max(t1 - t0, 0.0),
                               data={"slot": slot, "batch": 1,
                                     "suffix_tokens": width,
                                     "cached_tokens": int(r.cached_len),
                                     "chunk": width, "pos": pos0})
                self.obs.observe("engine_chunk_width_tokens", float(width))
                self.obs.inc("engine_compile_cache_total",
                             {"kind": "chunk",
                              "hit": "false" if fresh else "true"})
                # Calibration sample: roofline prediction for prefilling a
                # prompt to pos0+width with pos0 tokens already resident.
                if self.cost is not None and not fresh:
                    self.obs.calibrate(
                        "prefill_chunk",
                        self.cost.prefill_cost(pos0 + width, cached=pos0),
                        max(t1 - t0, 1e-9))
            if st.pos >= int(r.prompt_len):
                completed.append((slot, logits))
        for slot, logits in completed:
            self._promote_slot(slot, logits)

    def _promote_slot(self, slot: int, logits: torch.Tensor) -> None:
        """Chunked prefill finished: publish computed prefix blocks to the
        radix host store, sample the first token, move the slot to decode."""
        st = self._prefilling.pop(slot)
        r = st.req
        first = self._sample(logits)     # waits for the chunk's forward pass
        if self.radix is not None and st.pin_node is not None:
            self._publish_blocks(slot, self._path(st.pin_node))
        t = self.now()
        r.state = RequestState.RUNNING_DECODE
        r.first_token_time = t
        r.generated = 1
        if self.obs is not None:
            self.obs.event("promote", t, request_id=r.request_id,
                           replica_id=self.e.engine_id,
                           data={"slot": slot,
                                 "prompt_len": int(r.prompt_len)})
            self.obs.event("first_token", t, request_id=r.request_id,
                           replica_id=self.e.engine_id)
        self.tokens_out += 1
        self.output_tokens[r.request_id] = [int(first[0, 0])]
        self.slot_pos[slot] = int(r.prompt_len)
        self.last_tokens[slot, 0] = first[0, 0]
        self._slot_last_tok[slot] = t
        self.slot_state[slot] = _SlotState(
            req=r, seq_id=st.seq_id, budget_left=r.max_new_tokens - 1,
            pin_node=st.pin_node, cap_tokens=st.cap_tokens)
        if r.max_new_tokens <= 1:
            self._finish_slot(slot)

    # ---- decode -------------------------------------------------------------

    def _grow_chunked(self, slot: int, st: _SlotState) -> None:
        """Per-slot KV growth in chunked/prefix mode: capacity is tracked in
        ``cap_tokens`` (radix-resident + private blocks); one private block
        is appended when the next token would exceed it.  Under pressure the
        radix sheds a cold cached block first (running sequences outrank the
        prefix cache), then LIFO recompute preemption applies as in the
        bucketed mode."""
        total = int(self.slot_pos[slot]) + 1
        if total <= st.cap_tokens:
            return
        if self.pool.free_blocks < 1 and self.radix is not None:
            self.radix.evict(1)
        if self.pool.free_blocks >= 1 or len(self.slot_state) <= 1:
            self.pool.allocate_unchecked(st.seq_id, self.e.block_size)
            st.cap_tokens += self.e.block_size
        else:
            self._preempt_slot(slot)

    def _decode_tick(self) -> None:
        if not self.slot_state:
            return
        if self._prefilling:
            self.interleaved_ticks += 1
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
                if self._chunked:
                    self._grow_chunked(slot, st)
                elif not self.pool.grow(st.seq_id,
                                        int(self.slot_pos[slot]) + 1):
                    if len(self.slot_state) > 1:
                        self._preempt_slot(slot)
                    # else: single sequence — let it run (pool undersized)
            toks = torch.from_numpy(self.last_tokens).to(self.device)
            logits, self.caches = decode_step(self.params, toks, self.caches,
                                              self.slot_pos, self.cfg,
                                              policy=self.policy,
                                              moe_impl=self.e.moe_impl)
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
        if self.radix is not None and st.pin_node is not None:
            self.radix.unpin(st.pin_node)
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
        if self.radix is not None and st.pin_node is not None:
            self.radix.unpin(st.pin_node)
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
            "prefilling": len(self._prefilling),
            "waiting": self.sched.waiting(),
            "finished": len(self.finished),
            "tokens_out": self.tokens_out,
        }
        if self.obs is not None and self.obs.metrics is not None:
            hb["metrics"] = self.obs.metrics.snapshot()
        return hb

    def stats(self) -> dict:
        """Run summary: throughput, terminal accounting, padding waste,
        chunked-prefill / prefix-reuse counters, radix stats, the host KV
        copies, and the decode inter-token-gap (TBT) percentiles."""
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
            "chunks": self.chunks_run,
            "chunk_tokens": self.chunk_tokens,
            "interleaved_ticks": self.interleaved_ticks,
            "prefix_saved_tokens": self.prefix_saved_tokens,
            "radix": (self.radix.stats() if self.radix is not None else {}),
            "radix_copies": dict(self.radix_copies),
            "decode_tbt_p95": (float(np.percentile(self.decode_gaps, 95))
                               if self.decode_gaps else 0.0),
            "decode_tbt_max": (float(max(self.decode_gaps))
                               if self.decode_gaps else 0.0),
        }
