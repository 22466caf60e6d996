"""Request-lifecycle tracer: span/event records + flight recorder.

Every stage of a request's life across the cluster emits one lightweight
:class:`TraceEvent` through a :class:`TraceRecorder` threaded through the
simulator, replicas, router, admission controller, and serving engine:

    arrival → admit/defer/deny → route (with cost) → enqueue →
    dispatch (queue exit) → prefill (cached-vs-suffix split) →
    handoff / prefix_fetch (link + bytes) → decode ticks →
    finish / shed / deadline_drop

Instants carry ``(t, kind, request_id, replica_id, data)``; batch-level
work (prefill/decode ticks) is recorded as *spans* with a duration so the
exported trace shows engine occupancy per replica.  Emission is the hot
path: the ring stores plain ``(t, kind, request_id, replica_id, dur,
data)`` tuples — one tuple pack plus a deque append, no object
construction — and :class:`TraceEvent` views are materialized only on
read (``request_events`` / export / post-mortem).

**Flight recorder**: the event buffer is a bounded ring (oldest events
fall off), so tracing a long run has O(capacity) memory.  Control-plane
failure/straggler events call :meth:`TraceRecorder.dump` which freezes a
copy of the ring — the post-mortem view (``postmortem(request_id)``)
reconstructs what happened to any request still in the window, the way a
hardware flight recorder survives the crash it records.

**Export**: ``to_chrome_trace()`` emits the Chrome trace-event JSON format
(Perfetto-loadable: https://ui.perfetto.dev, "Open trace file").  Replicas
map to processes (pid), requests to threads (tid) so Perfetto groups a
request's lifecycle on one track; spans use phase ``X``, instants phase
``i``.  ``tools/trace_summary.py`` consumes the same JSON offline.
"""

from __future__ import annotations

import json
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

# Stage ordering for per-request breakdowns (postmortem + trace_summary):
# the wait/prefill/decode boundaries of a request's life.  ``park`` /
# ``promote`` are the real engine's slot-lifecycle instants (slot parked at
# the scratch position for chunked prefill; slot promoted to decode).
LIFECYCLE_KINDS = (
    "arrival", "admit", "defer", "shed", "budget_deny", "route", "enqueue",
    "dispatch", "deadline_drop", "prefix_fetch", "handoff", "first_token",
    "park", "promote", "preempt", "evict", "finish",
)

# Span (phase X) stage taxonomy shared by the DES and the real engine:
# ``prefill`` / ``decode`` are the DES's batch spans; the engine adds
# ``chunk`` (one chunked-prefill step), ``recompute`` (a chunk re-running a
# preempted request's prompt), and ``attach`` (radix prefix-KV copy into a
# slot).  tools/trace_summary.py groups spans by this map.
SPAN_STAGES = {
    "prefill": "prefill", "chunk": "prefill", "recompute": "prefill",
    "attach": "attach", "decode": "decode",
}


@dataclass(slots=True)
class TraceEvent:
    """One lifecycle event (read-side view).  ``dur`` > 0 makes it a span
    (phase X in the Chrome export); ``data`` carries kind-specific payload
    (cost terms, byte counts, cached/suffix splits...).  The recorder's
    ring holds these as plain tuples; this view is materialized lazily by
    the per-request accessors."""

    t: float
    kind: str
    request_id: int = -1
    replica_id: int = -1
    dur: float = 0.0
    data: Optional[dict] = None


@dataclass
class FlightDump:
    """A frozen copy of the ring taken at a failure/straggler event."""

    t: float
    reason: str
    events: list = field(default_factory=list)


class TraceRecorder:
    """Bounded ring of lifecycle events + failure dumps + exporters.

    The ring holds raw ``(t, kind, request_id, replica_id, dur, data)``
    tuples so :meth:`emit` is one tuple pack + deque append (sub-µs);
    readers get :class:`TraceEvent` views."""

    def __init__(self, capacity: int = 65536, max_dumps: int = 8):
        self.capacity = capacity
        self.events: deque[tuple] = deque(maxlen=capacity)
        self.dumps: list[FlightDump] = []
        self.max_dumps = max_dumps
        self.emitted = 0              # total ever (ring may have dropped some)

    # ---- recording -------------------------------------------------------

    def emit(self, kind: str, t: float, request_id: int = -1,
             replica_id: int = -1, dur: float = 0.0,
             data: Optional[dict] = None) -> None:
        """Append one event to the ring (hot path: no object allocation
        beyond the tuple itself)."""
        self.events.append((t, kind, request_id, replica_id, dur, data))
        self.emitted += 1

    def dump(self, reason: str, t: float) -> Optional[FlightDump]:
        """Freeze the current ring (flight-recorder dump on failure or
        straggler detection).  Bounded: oldest dumps are discarded."""
        d = FlightDump(t=t, reason=reason, events=list(self.events))
        self.dumps.append(d)
        if len(self.dumps) > self.max_dumps:
            self.dumps.pop(0)
        return d

    # ---- per-request views -----------------------------------------------

    def request_events(self, request_id: int) -> list[TraceEvent]:
        """All events for one request still in the ring (or any dump),
        ordered by time."""
        seen: dict[tuple, tuple] = {}
        for d in self.dumps:
            for e in d.events:
                if e[2] == request_id:
                    seen[(e[0], e[1], e[3])] = e
        for e in self.events:
            if e[2] == request_id:
                seen[(e[0], e[1], e[3])] = e
        return [TraceEvent(t=e[0], kind=e[1], request_id=e[2],
                           replica_id=e[3], dur=e[4], data=e[5])
                for _, e in sorted(seen.items())]

    def stage_breakdown(self, request_id: int) -> dict:
        """Per-stage time split for one request: ``{wait, prefill, decode,
        total}`` seconds, derived from its arrival / dispatch / first_token
        / finish events (0.0 for stages without both endpoints)."""
        ev = {e.kind: e.t for e in self.request_events(request_id)}
        out = {"wait": 0.0, "prefill": 0.0, "decode": 0.0, "total": 0.0}
        arr = ev.get("arrival", ev.get("enqueue"))
        if arr is None:
            return out
        if "dispatch" in ev:
            out["wait"] = max(0.0, ev["dispatch"] - arr)
        if "first_token" in ev and "dispatch" in ev:
            out["prefill"] = max(0.0, ev["first_token"] - ev["dispatch"])
        if "finish" in ev and "first_token" in ev:
            out["decode"] = max(0.0, ev["finish"] - ev["first_token"])
        end = ev.get("finish", max(ev.values()))
        out["total"] = max(0.0, end - arr)
        return out

    def postmortem(self, request_id: int) -> str:
        """Human-readable lifecycle reconstruction for one request (from
        the ring and any flight dumps) — the post-failure view."""
        evs = self.request_events(request_id)
        if not evs:
            return (f"request {request_id}: no events in the flight "
                    f"recorder window")
        lines = [f"post-mortem for request {request_id} "
                 f"({len(evs)} events in window):"]
        t0 = evs[0].t
        for e in evs:
            extra = ""
            if e.data:
                extra = " " + " ".join(f"{k}={v}" for k, v in
                                       sorted(e.data.items()))
            where = f" @replica{e.replica_id}" if e.replica_id >= 0 else ""
            lines.append(f"  t={e.t:9.4f}s (+{e.t - t0:8.4f}s) "
                         f"{e.kind:13s}{where}{extra}")
        br = self.stage_breakdown(request_id)
        lines.append(f"  stages: wait={br['wait']:.4f}s "
                     f"prefill={br['prefill']:.4f}s "
                     f"decode={br['decode']:.4f}s total={br['total']:.4f}s")
        return "\n".join(lines)

    # ---- export ----------------------------------------------------------

    def to_chrome_trace(self) -> dict:
        """Chrome trace-event JSON (Perfetto-loadable).  Replicas are
        processes; request lifecycles are per-request threads; batch spans
        (prefill/decode ticks) live on each replica's "engine" thread."""
        out: list[dict] = []
        pids: set[int] = set()
        for t, kind, request_id, replica_id, dur, data in self.events:
            pid = replica_id if replica_id >= 0 else 0
            ev: dict = {
                "name": kind,
                "pid": pid,
                "ts": t * 1e6,                    # µs
                "cat": "lifecycle",
            }
            if dur > 0.0:
                ev["ph"] = "X"
                ev["dur"] = dur * 1e6
                # Engine spans carrying a slot land on per-slot tracks so
                # Perfetto shows one lane per slot; batch-level DES spans
                # (no slot) share the replica's track 0.
                ev["tid"] = (data.get("slot", 0)
                             if isinstance(data, dict) else 0)
                ev["cat"] = "engine"
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
                ev["tid"] = request_id if request_id >= 0 else 0
            args = dict(data) if data else {}
            if request_id >= 0:
                args["request_id"] = request_id
            if args:
                ev["args"] = args
            out.append(ev)
            pids.add(pid)
        meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                 "args": {"name": f"replica {pid}"}} for pid in sorted(pids)]
        return {"traceEvents": meta + out, "displayTimeUnit": "ms"}

    def dump_chrome_trace(self, path: str) -> None:
        """Write the Perfetto-loadable trace JSON to ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)

    def stats(self) -> dict:
        """Recorder telemetry: ring occupancy, total emitted, dumps."""
        return {"events_in_ring": len(self.events),
                "events_emitted": self.emitted,
                "capacity": self.capacity,
                "dumps": [(d.t, d.reason, len(d.events))
                          for d in self.dumps]}
