"""The PyTorch port's copy of the EWSJF scheduler stack, against the JAX
package's: the same request stream under the same ``now`` sequence must
give the same batch plans, tick by tick, including across re-optimisations.

The port's ``CostModel`` defaults to one H100's peaks; EWSJF scores through
``C_prefill``, so the parity runs give it the JAX package's constants."""

import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro.core.partition import PartitionConfig as JPartitionConfig
from repro.core.partition import refine_and_prune as j_refine
from repro_torch.core.partition import PartitionConfig as TPartitionConfig
from repro_torch.core.partition import refine_and_prune as t_refine

V5E = dict(peak_flops=197e12, hbm_bw=819e9, n_chips=4)   # repro cost_model:24-27


def _stream(seed: int, n: int = 240):
    """(arrival, prompt_len, max_new) triples: 75% short, 25% long."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(0.05, n))
    out = []
    for i in range(n):
        short = rng.random() < 0.75
        ln = int(rng.integers(16, 200) if short else rng.integers(600, 3000))
        out.append((float(t[i]), ln, int(rng.integers(4, 64))))
    return out


def _make(pkg, name: str):
    if name == "fcfs":
        return pkg.FCFSScheduler()
    if name == "sjf":
        return pkg.SJFScheduler()
    cost = (pkg.CostModel(**V5E) if pkg is tcore else pkg.CostModel())
    cfg = pkg.EWSJFConfig(min_history=16, reopt_interval=1.5,
                          trial_interval=3.0)
    return pkg.EWSJFScheduler(cfg, cost)


def _drive(pkg, name: str, stream, ticks: int = 160, dt: float = 0.1):
    """Submit arrivals up to each ``now``, re-optimise, tick, finish what
    was dispatched; returns the dispatched ids per tick and the scheduler."""
    sched = _make(pkg, name)
    reqs = [pkg.Request(prompt_len=ln, arrival_time=t, max_new_tokens=m,
                        request_id=50_000 + i)
            for i, (t, ln, m) in enumerate(stream)]
    plans, pi = [], 0
    for k in range(ticks):
        now = k * dt
        while pi < len(reqs) and reqs[pi].arrival_time <= now:
            sched.submit(reqs[pi], now=now)
            pi += 1
        if hasattr(sched, "maybe_reoptimize"):
            sched.maybe_reoptimize(now)
        budget = pkg.BatchBudget(max_requests=4, max_tokens=4096,
                                 kv_blocks_free=256, block_size=16)
        plan = sched.tick(now, budget)
        plans.append([r.request_id for r in plan.requests])
        for r in plan.requests:
            r.first_token_time = now + 0.02
            r.generated = r.max_new_tokens
            r.finish_time = now + 0.05
            sched.on_finish(r, r.finish_time)
    return plans, sched


@pytest.mark.parametrize("name", ["fcfs", "sjf", "ewsjf"])
def test_batch_plans_match_tick_by_tick(name):
    stream = _stream(seed=7)
    jplans, jsched = _drive(jcore, name, stream)
    tplans, tsched = _drive(tcore, name, stream)
    assert sum(len(p) for p in jplans) > 100
    for k, (a, b) in enumerate(zip(jplans, tplans)):
        assert a == b, f"tick {k}: JAX {a} vs port {b}"
    if name == "ewsjf":
        assert jsched.reopt_count >= 2
        assert tsched.reopt_count == jsched.reopt_count
        jb = [(q.bounds.lo, q.bounds.hi) for q in jsched.manager.queues]
        tb = [(q.bounds.lo, q.bounds.hi) for q in tsched.manager.queues]
        assert jb == tb


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_refine_and_prune_same_boundaries(seed):
    rng = np.random.default_rng(seed)
    lengths = np.concatenate([rng.integers(8, 120, 400),
                              rng.integers(500, 900, 150),
                              rng.integers(2000, 4000, 60)])
    jb = j_refine(lengths, JPartitionConfig())
    tb = t_refine(lengths, TPartitionConfig())
    assert len(jb) > 1
    assert [(q.lo, q.hi) for q in jb] == [(q.lo, q.hi) for q in tb]


def test_cost_model_defaults_and_v5e_equivalence():
    h100 = tcore.CostModel()
    assert (h100.peak_flops, h100.hbm_bw, h100.n_chips) == (989e12, 3.35e12, 1)
    jm, tm = jcore.CostModel(), tcore.CostModel(**V5E)
    for b in (16.0, 256.0, 4096.0):
        assert tm.c_prefill(b) == jm.c_prefill(b)
        assert tm.prefill_cost(b, cached=b / 4) == jm.prefill_cost(b, cached=b / 4)
        assert tm.prefill_step_time(int(b), b / 2) == jm.prefill_step_time(int(b), b / 2)
    assert tm.decode_step_time(8, 4096) == jm.decode_step_time(8, 4096)
    assert tm.attach_copy_time(512) == jm.attach_copy_time(512)
    # one H100 at its data-sheet peaks prefills faster than four v5e chips
    assert h100.c_prefill(2048) < jm.c_prefill(2048)
