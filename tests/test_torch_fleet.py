"""The port's live engine fleet (``repro_torch.cluster.engine_fleet``) on
torch engines, on the CPU.

Twins of ``tests/test_engine_fleet.py`` (the fleet invariants under a
seeded fault / drain driver) and of the engine tests of
``tests/test_fleet_conformance.py`` (the port's DES fleet against the
port's live fleet), then the port's fleet against the JAX package's on one
trace, and the bytes a remote prefix fetch ships.  Engines run the
llama2-13b smoke config on weights bridged from the JAX initialisation, in
f32 (the engine default); greedy tokens are compared exactly, as
``tests/test_torch_chunked.py`` compares engines whose logits agree to
5e-5.

``FLEET_SEED`` (env, default 0) reseeds the randomized driver, as in the
JAX harness."""

import copy
import os

import jax
import numpy as np
import pytest

import repro.cluster as jcl
import repro.core as jcore
import repro.kvplane as jkv
import repro_torch.core as tcore
from repro.configs import get_smoke_config as jax_smoke
from repro.models import init_params as jax_init
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.cluster import (AdmissionController, ClusterSimulator,
                                 EngineFleet, EWSJFRouter, HealthConfig,
                                 HealthMonitor, ReplicaModel, ReplicaParams)
from repro_torch.configs import get_smoke_config
from repro_torch.core import CostModel, FCFSScheduler, Request
from repro_torch.kvplane import (LinkTopology, LinkTopologyConfig,
                                 PrefixDirectory, PrefixDirectoryConfig)
from repro_torch.kvplane.topology import PrefixFetch
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.replay import (EXACT_SCHEDULERS, TAU_BOUND,
                                        burst_trace, kendall_tau,
                                        make_scheduler)

FLEET_SEED = int(os.environ.get("FLEET_SEED", "0"))
ARCH = "llama2-13b"
V5E = dict(peak_flops=197e12, hbm_bw=819e9, n_chips=4)   # repro cost_model:24-27
V5E_ICI = 50e9                                            # repro cost_model:27


@pytest.fixture(scope="module")
def model():
    """(JAX config, port config, JAX params, port params)."""
    jcfg, tcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    return jcfg, tcfg, jp, tp


FLEET_ECFG = dict(max_slots=4, kv_pool_tokens=4096, max_prefill_tokens=256,
                  chunk_prefill_tokens=128, enable_prefix_cache=True,
                  decode_steps_per_tick=4)


def _engine(model, eid, sched=None, **kw):
    _, tcfg, _, tp = model
    e = EngineConfig(**{**FLEET_ECFG, **kw}, engine_id=eid)
    return ServingEngine(tcfg, tp, sched or FCFSScheduler(), e, device="cpu")


def _fleet(model, n, admission=True, timeout=5.0):
    engines = [_engine(model, i) for i in range(n)]
    return EngineFleet(
        engines,
        monitor=HealthMonitor(HealthConfig(heartbeat_timeout=timeout)),
        directory=PrefixDirectory(PrefixDirectoryConfig(sync_interval=0.0)),
        topology=LinkTopology(),
        admission=AdmissionController() if admission else None)


def _trace(cfg, n, seed):
    return burst_trace(n, seed=seed, vocab_size=cfg.vocab_size,
                       short=(16, 48), long=(64, 96), long_frac=0.3,
                       out_range=(4, 8))


def _assert_terminal_invariants(fleet, submitted_ids,
                                drain_marks=None) -> None:
    """The property suite of the JAX harness, on the port's fleet."""
    fin = fleet.finished()
    shed = list(fleet.shed)
    for rep in fleet.replicas:
        shed.extend(rep.engine.shed)
    ids = sorted([r.request_id for r in fin] + [r.request_id for r in shed])
    assert ids == sorted(submitted_ids), (ids, submitted_ids)
    for rep in fleet.replicas:
        e = rep.engine
        assert not e.slot_state and not e._prefilling
        if e.radix is not None:
            e.radix.check_invariants()
            assert all(nd.pins == 0 for nd in e.radix._nodes.values())
            want = {e.radix._alloc_key(nid) for nid in e.radix._nodes}
            assert set(e.pool.allocs) == want
            # every host KV block belongs to a live radix node
            assert set(e._node_kv) <= set(e.radix._nodes)
    for rid in fleet.directory.advertised_replicas():
        rep = fleet._by_id[rid]
        assert rep.alive and not rep.draining
    for eid, mark in (drain_marks or {}).items():
        assert len(fleet._by_id[eid].engine.dispatch_log) == mark


def _drive(fleet, reqs, rng, events=()):
    """The JAX harness's manual fleet loop with events at randomized
    early iterations."""
    submitted = [r.request_id for r in reqs]
    now = fleet.now()
    for r in reqs:
        fleet.submit(r, now)
    schedule = {}
    for kind, eid in events:
        it = 1 + int(rng.integers(0, 10))
        while it in schedule:
            it += 1
        schedule[it] = (kind, eid)
    drain_marks = {}
    for i in range(4000):
        now = fleet.now()
        done = (fleet._accounted() >= len(reqs) and not fleet.backlog
                and (fleet.admission is None
                     or not fleet.admission.retry_pending()))
        due = sorted(k for k in schedule if k <= i or done)
        for k in due:
            kind, eid = schedule.pop(k)
            if kind == "fail":
                fleet.fail_engine(eid, now)
            else:
                fleet.drain_engine(eid, now)
                drain_marks[eid] = len(
                    fleet._by_id[eid].engine.dispatch_log)
            assert eid not in fleet.directory.advertised_replicas()
        fleet._pump(now)
        if fleet.backlog:
            still = []
            for req in fleet.backlog:
                rep = fleet.router.select(fleet.replicas, req, now)
                if rep is None:
                    still.append(req)
                else:
                    rep.submit(req, now)
            fleet.backlog = still
        if rng.random() < 0.3:
            fleet.prefix_sync(now)
        if rng.random() < 0.3:
            fleet.health_round(now)
        fleet.step()
        if (not schedule and fleet._accounted() >= len(reqs)
                and not fleet.backlog
                and (fleet.admission is None
                     or not fleet.admission.retry_pending())):
            break
    return submitted, drain_marks


# ---- twins of tests/test_engine_fleet.py ------------------------------------------

def test_fleet_serves_burst(model):
    fleet = _fleet(model, 2, admission=False)
    reqs = _trace(model[1], 10, seed=FLEET_SEED)
    res = fleet.serve(reqs, max_ticks=4000)
    assert res["finished"] + res["shed"] == 10
    assert res["routed"] >= 10
    assert all(st["dispatched"] > 0 for st in res["engines"].values())
    _assert_terminal_invariants(fleet, [r.request_id for r in reqs])


@pytest.mark.parametrize("kind", ["fail", "drain"])
def test_fleet_randomized_events(model, kind):
    """One mid-burst drain or failure of engine 0 at a seeded iteration
    (the JAX harness draws the kind; here both run)."""
    rng = np.random.default_rng(FLEET_SEED)
    fleet = _fleet(model, 2)
    reqs = _trace(model[1], 12, seed=FLEET_SEED + 1)
    submitted, marks = _drive(fleet, reqs, rng, events=[(kind, 0)])
    _assert_terminal_invariants(fleet, submitted, marks)
    res = fleet.result()
    assert res["finished"] + res["shed"] == len(submitted)
    assert res["failures" if kind == "fail" else "drains"] == [0]


def _warm_then_route(model, cost):
    """Engine 0 serves a 64-token shared prefix and advertises it; the
    holder's queue is loaded, so the router sends the next shared-prefix
    arrival to the other engine with a remote fetch plan, which the fleet
    executes.  Returns (fleet, src, dst, hot request)."""
    engines = [_engine(model, i) for i in range(2)]
    fleet = EngineFleet(
        engines, cost=cost, monitor=HealthMonitor(HealthConfig()),
        directory=PrefixDirectory(PrefixDirectoryConfig(sync_interval=0.0)),
        topology=LinkTopology())
    e0, e1 = engines
    shared = list(range(100, 164))                      # 4 full blocks
    warm = Request(request_id=0, prompt_len=64, max_new_tokens=4,
                   arrival_time=0.0)
    warm.prompt_tokens = np.asarray(shared, dtype=np.int32)
    fleet.submit(warm, fleet.now())
    for _ in range(400):
        fleet.step()
        if len(e0.finished) + len(e1.finished) >= 1:
            break
    fleet.prefix_sync()
    holder = fleet.directory.advertised_replicas()
    assert holder, "warm engine advertised nothing"
    src = fleet._by_id[next(iter(holder))]
    dst = next(r for r in fleet.replicas if r.replica_id != src.replica_id)
    for i in range(6):
        filler = Request(request_id=100 + i, prompt_len=96,
                         max_new_tokens=8, arrival_time=0.0)
        fleet._stamp(filler)
        src.engine.sched.submit(filler, fleet.now())
    hot = Request(request_id=1, prompt_len=96, max_new_tokens=4,
                  arrival_time=0.0)
    hot.prompt_tokens = np.asarray(shared + list(range(200, 232)),
                                   dtype=np.int32)
    fleet._stamp(hot)
    return fleet, src, dst, hot


def test_fleet_prefix_handoff_via_router(model):
    """Directory-driven cross-engine reuse with real host KV blocks: the
    JAX harness's compute-bound routing cost (``mfu=1e-4``) makes a
    64-token saving beat the link at smoke scale."""
    fleet, src, dst, hot = _warm_then_route(model,
                                            CostModel(n_chips=1, mfu=1e-4))
    probe_before = dst.prefix_probe(hot.prompt_hashes)
    picked = fleet.router.select(fleet.replicas, hot, fleet.now())
    assert picked.replica_id == dst.replica_id
    assert hot.prefix_fetch is not None
    assert hot.prefix_fetch.src_replica == src.replica_id
    fleet._handoff(hot, dst, fleet.now())
    assert dst.prefix_probe(hot.prompt_hashes) > probe_before
    assert fleet.stats.prefix_fetches == 1
    assert fleet.stats.prefix_fetch_blocks > 0
    assert fleet.stats.prefix_fetch_bytes > 0
    assert fleet.topology.stats()["fetches"] == 1
    dst.submit(hot, fleet.now())
    for _ in range(600):
        fleet.step()
        if hot in dst.engine.finished:
            break
    assert hot in dst.engine.finished
    assert hot.cached_len == 64
    assert dst.engine.prefix_saved_tokens >= 64
    for rep in fleet.replicas:
        rep.engine.radix.check_invariants()
    if not dst.engine.slot_state and not dst.engine._prefilling:
        assert all(nd.pins == 0 for nd in dst.engine.radix._nodes.values())


def test_prefix_fetch_bytes_are_the_blocks_kv(model):
    """The fleet counts the host bytes a fetch ships as each exported
    block's own elements, never its pinned run's whole storage:
    blocks × block_size × n_layers × 2 × K × hd × itemsize; the blocks land
    packed in one run per layer and hold the holder's values."""
    fleet, src, dst, hot = _warm_then_route(model,
                                            CostModel(n_chips=1, mfu=1e-4))
    cfg = model[1]
    fleet.router.select(fleet.replicas, hot, fleet.now())
    want_blocks = src.engine.export_prefix_blocks(hot.prompt_hashes, 4)
    assert len(want_blocks) == 4
    fleet._handoff(hot, dst, fleet.now())
    landed = fleet.stats.prefix_fetch_blocks
    assert landed == 4
    itemsize = want_blocks[0][0]["k"].element_size()
    per_block = (16 * cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim
                 * itemsize)
    assert fleet.stats.prefix_fetch_bytes == landed * per_block
    # each exported tensor is a view: counting its storage would count
    # every block of its run, K and V, once per view
    storage = sum(t.untyped_storage().nbytes() for blk in want_blocks
                  for layer in blk for t in layer.values())
    assert storage == 8 * fleet.stats.prefix_fetch_bytes
    got = dst.engine.export_prefix_blocks(hot.prompt_hashes, 4)
    for a, b in zip(want_blocks, got):
        for la, lb in zip(a, b):
            assert (la["k"] == lb["k"]).all() and (la["v"] == lb["v"]).all()
    # the imported blocks share one host run per layer on the destination
    runs = {id(dst.engine._node_kv[nd][0]) for nd in dst.engine._node_kv}
    assert len(runs) == 1


def test_heartbeat_lapse_excluded_within_one_round(model):
    fleet = _fleet(model, 2, timeout=0.5)
    reqs = _trace(model[1], 8, seed=FLEET_SEED + 2)
    now = fleet.now()
    for r in reqs:
        fleet.submit(r, now)
    for _ in range(2):
        fleet.step()
    victim = fleet.replicas[0]
    had_work = victim.engine.has_work()
    fleet.suppress_heartbeat(0)
    lapse_now = fleet.now() + 1.0
    failed = fleet.health_round(lapse_now)
    assert failed == [0]
    assert not victim.alive
    assert not victim.accepts_prefill()
    probe = Request(request_id=999, prompt_len=32, max_new_tokens=4,
                    arrival_time=0.0)
    fleet._stamp(probe)
    picked = fleet.router.select(fleet.replicas, probe, lapse_now)
    assert picked is None or picked.replica_id != 0
    assert 0 not in fleet.directory.advertised_replicas()
    if had_work:
        assert fleet.stats.reenqueued > 0
    for _ in range(4000):
        now = fleet.now()
        fleet._pump(now)
        if fleet.backlog:
            still = []
            for req in fleet.backlog:
                rep = fleet.router.select(fleet.replicas, req, now)
                if rep is None:
                    still.append(req)
                else:
                    rep.submit(req, now)
            fleet.backlog = still
        fleet.step()
        if (fleet._accounted() >= len(reqs) and not fleet.backlog
                and not fleet.admission.retry_pending()):
            break
    _assert_terminal_invariants(fleet, [r.request_id for r in reqs])
    assert len(fleet.replicas[1].engine.dispatch_log) > 0


def test_degraded_handoff_is_harmless(model):
    fleet = _fleet(model, 2, admission=False)
    req = Request(request_id=5, prompt_len=64, max_new_tokens=4,
                  arrival_time=0.0)
    fleet._stamp(req)
    req.prefix_fetch = PrefixFetch(src_replica=0, blocks=4)
    fleet.fail_engine(0)
    dst = fleet.replicas[1]
    fleet._handoff(req, dst, fleet.now())
    assert req.prefix_fetch is None
    assert fleet.stats.prefix_fetches == 0
    assert fleet.stats.prefix_fetch_bytes == 0


def test_fleet_three_engine_fault_injection(model):
    """3 engines, a failure and a drain at seeded points of one burst."""
    rng = np.random.default_rng(FLEET_SEED + 7)
    fleet = _fleet(model, 3)
    reqs = _trace(model[1], 16, seed=FLEET_SEED + 3)
    submitted, marks = _drive(fleet, reqs, rng,
                              events=[("fail", 0), ("drain", 1)])
    _assert_terminal_invariants(fleet, submitted, marks)
    res = fleet.result()
    assert res["finished"] + res["shed"] == len(submitted)
    assert res["failures"] == [0] and res["drains"] == [1]
    assert res["engines"][2]["dispatched"] > 0


def test_fleet_shares_one_set_of_weights(model):
    fleet = _fleet(model, 2, admission=False)
    e0, e1 = (rep.engine for rep in fleet.replicas)
    assert e0.params is e1.params
    assert e0.params.embed.data_ptr() == e1.params.embed.data_ptr()
    assert e0.caches[0]["k"].data_ptr() != e1.caches[0]["k"].data_ptr()
    assert e0._t0 == e1._t0 == fleet._t0


# ---- twins of the engine tests of tests/test_fleet_conformance.py -----------------

N_ENGINES = 2
BUDGETS = dict(max_slots=4, max_prefill_tokens=256, kv_pool_tokens=8192,
               block_size=16, decode_steps_per_tick=4)
QUIET_HEALTH = HealthConfig(check_interval=1e9, heartbeat_timeout=1e9)


def _des_fleet(sched_name, cost):
    params = ReplicaParams(max_num_seqs=BUDGETS["max_slots"],
                           max_prefill_tokens=BUDGETS["max_prefill_tokens"],
                           kv_pool_tokens=BUDGETS["kv_pool_tokens"],
                           block_size=BUDGETS["block_size"],
                           decode_steps_per_tick=BUDGETS[
                               "decode_steps_per_tick"],
                           bucket_pad=True)
    return [ReplicaModel(i, cost, scheduler=make_scheduler(sched_name),
                         params=params) for i in range(N_ENGINES)]


def _live_fleet(model, sched_name, cost):
    _, tcfg, _, tp = model
    engines = [ServingEngine(tcfg, tp, make_scheduler(sched_name),
                             EngineConfig(**BUDGETS, engine_id=i),
                             device="cpu") for i in range(N_ENGINES)]
    return EngineFleet(engines, router=EWSJFRouter(cost=cost), cost=cost,
                       monitor=HealthMonitor(QUIET_HEALTH),
                       calibrated_routing=False)


def _conf_trace(cfg, n=14, seed=0):
    return burst_trace(n, seed=seed, vocab_size=cfg.vocab_size,
                       short=(16, 48), long=(64, 96), long_frac=0.3,
                       out_range=(4, 8))


def _run_both(model, sched_name, seed=0):
    cost = CostModel()
    des_reqs = _conf_trace(model[1], seed=seed)
    live_reqs = copy.deepcopy(des_reqs)
    des = _des_fleet(sched_name, cost)
    ClusterSimulator(des, EWSJFRouter(cost=cost), cost,
                     health=QUIET_HEALTH).run(des_reqs)
    fleet = _live_fleet(model, sched_name, cost)
    res = fleet.serve(live_reqs, max_ticks=6000)
    assert res["finished"] == len(live_reqs), res
    return ({rep.replica_id: [r.request_id for r, _ in rep.dispatch_log]
             for rep in des},
            {rep.replica_id: rep.dispatch_order() for rep in fleet.replicas})


def test_fcfs_dispatch_exact(model):
    assert "fcfs" in EXACT_SCHEDULERS
    des, live = _run_both(model, "fcfs")
    assert sum(len(v) for v in des.values()) == 14
    for rid in des:
        assert des[rid] == live[rid], (rid, des[rid], live[rid])
    assert all(des.values())


def test_ewsjf_dispatch_tau(model):
    des, live = _run_both(model, "ewsjf", seed=1)
    checked = 0
    for rid in des:
        common = set(des[rid]) & set(live[rid])
        if len(common) >= 2:
            tau = kendall_tau(des[rid], live[rid])
            assert tau >= TAU_BOUND, (rid, tau, des[rid], live[rid])
            checked += 1
    assert checked >= 1


def test_routing_decisions_identical_uncalibrated(model):
    cost = CostModel()
    des = _des_fleet("fcfs", cost)
    r_des = EWSJFRouter(cost=cost)
    fleet = _live_fleet(model, "fcfs", cost)
    des_reqs = _conf_trace(model[1], n=12, seed=2)
    live_reqs = copy.deepcopy(des_reqs)
    for rd, rl in zip(des_reqs, live_reqs):
        pick_d = r_des.select(des, rd, 0.0)
        pick_l = fleet.router.select(fleet.replicas, rl, 0.0)
        assert pick_d is not None and pick_l is not None
        assert pick_d.replica_id == pick_l.replica_id, rd.request_id
        pick_d.submit(rd, 0.0)
        pick_l.submit(rl, 0.0)


# ---- the port's fleet against the JAX package's ----------------------------------

def _jax_fleet(model, sched, n):
    jcfg, _, jp, _ = model
    engines = [JaxEngine(jcfg, jp, {"fcfs": jcore.FCFSScheduler,
                                    "sjf": jcore.SJFScheduler}[sched](),
                         JaxEngineConfig(**FLEET_ECFG, engine_id=i))
               for i in range(n)]
    return jcl.EngineFleet(
        engines, cost=jcore.CostModel(),
        monitor=jcl.HealthMonitor(jcl.HealthConfig()),
        directory=jkv.PrefixDirectory(jkv.PrefixDirectoryConfig(
            sync_interval=0.0)),
        topology=jkv.LinkTopology(), calibrated_routing=False)


def _port_fleet(model, sched, n):
    engines = [_engine(model, i, sched=make_scheduler(sched))
               for i in range(n)]
    return EngineFleet(
        engines, cost=CostModel(**V5E, link_bw=V5E_ICI),
        monitor=HealthMonitor(HealthConfig()),
        directory=PrefixDirectory(PrefixDirectoryConfig(sync_interval=0.0)),
        topology=LinkTopology(LinkTopologyConfig(link_bandwidth=V5E_ICI)),
        calibrated_routing=False)


def _shared_trace(pkg, cfg, n=12):
    """A burst in which half the prompts share a 48-token prefix."""
    rng = np.random.default_rng(21)
    prefix = rng.integers(0, cfg.vocab_size, size=(48,)).astype(np.int32)
    out = []
    for i in range(n):
        pl = int(rng.integers(24, 112))
        toks = rng.integers(0, cfg.vocab_size, size=(pl,)).astype(np.int32)
        if i % 2 and pl > 56:
            toks[:48] = prefix
        out.append(pkg.Request(request_id=i, arrival_time=0.0, prompt_len=pl,
                               max_new_tokens=int(rng.integers(3, 7)),
                               prompt_tokens=toks))
    return out


@pytest.fixture(scope="module")
def fleet_pair(model):
    """The JAX and the port fleet (2 chunked+radix FCFS engines, prefix
    directory and link topology at the v5e figures) over one burst."""
    jf = _jax_fleet(model, "fcfs", 2)
    jres = jf.serve(_shared_trace(jcore, model[0]), max_ticks=4000)
    tf = _port_fleet(model, "fcfs", 2)
    tres = tf.serve(_shared_trace(tcore, model[1]), max_ticks=4000)
    return jf, jres, tf, tres


def test_fleet_dispatch_and_tokens_match_jax(fleet_pair):
    """The same engine gets the same requests in the same order, and every
    request the same greedy tokens."""
    jf, jres, tf, tres = fleet_pair
    assert jres["finished"] == tres["finished"] == 12
    for jr, tr in zip(jf.replicas, tf.replicas):
        assert tr.dispatch_order() == jr.dispatch_order()
        assert tr.engine.output_tokens == jr.engine.output_tokens
    assert all(st["dispatched"] for st in tres["engines"].values())


def test_fleet_results_match_jax(fleet_pair):
    """Routing, per-engine counters, radix reuse and the directory agree."""
    _, jres, _, tres = fleet_pair
    for key in ("routed", "reenqueued", "readmitted", "failures", "drains",
                "prefix_fetches", "prefix_fetch_blocks"):
        assert tres[key] == jres[key], key
    for eid, st in jres["engines"].items():
        for key in ("finished", "dispatched", "prefix_saved_tokens",
                    "preemptions", "kv_occupancy"):
            assert tres["engines"][eid][key] == st[key], (eid, key)
    assert tres["directory"] == jres["directory"]
