"""The port's copies of the cluster planes (``cluster/``) and of the rest of
the KV plane (``kvplane/topology.py``, ``directory.py``, ``workload.py``)
against the JAX package's, on seeded inputs.

The port's ``CostModel`` and link figures default to one H100's data-sheet
peaks and NVLink 4; every parity run gives them the JAX package's v5e
constants (``src/repro/core/cost_model.py:24-27``), so both sides price the
same work and must make the same decisions."""

import numpy as np
import pytest

import repro.cluster as jcl
import repro.core as jcore
import repro.kvplane as jkv
import repro_torch.cluster as tcl
import repro_torch.core as tcore
import repro_torch.kvplane as tkv
from repro_torch.core.cost_model import H100_NVLINK_BW

V5E = dict(peak_flops=197e12, hbm_bw=819e9, n_chips=4)   # repro cost_model:24-27
V5E_ICI = 50e9                                            # repro cost_model:27


def _cost(pkg, **kw):
    return pkg.CostModel(**V5E, link_bw=V5E_ICI, **kw) if pkg is tcore \
        else pkg.CostModel(**kw)


def _topology(kv):
    if kv is tkv:
        return kv.LinkTopology(kv.LinkTopologyConfig(link_bandwidth=V5E_ICI))
    return kv.LinkTopology()


# ---- the H100 link figure ---------------------------------------------------

def test_link_defaults_are_the_h100_nvlink_figure():
    """No TPU figure is a default: the cost model, the topology, the
    handoff channel and the router's fallback read one H100 NVLink 4
    direction (450 GB/s); the calibrated model keeps the field."""
    assert H100_NVLINK_BW == 450e9
    cost = tcore.CostModel()
    assert cost.link_bw == H100_NVLINK_BW
    assert tkv.LinkTopologyConfig().link_bandwidth == H100_NVLINK_BW
    assert tcl.HandoffChannel().bandwidth == H100_NVLINK_BW
    fit = tcore.cost_model.CalibratedCostModel.from_fit(
        tcore.CostModel(link_bw=123e9), {"prefill_chunk": 2.0})
    assert fit.link_bw == 123e9
    # the router's topology-less fetch estimate is bytes over cost.link_bw
    d = tkv.PrefixDirectory(tkv.PrefixDirectoryConfig(sync_interval=0.0))
    rep = tcl.ReplicaModel(0, cost, params=tcl.ReplicaParams(
        enable_prefix_cache=True))
    router = tcl.EWSJFRouter(cost=tcore.CostModel(link_bw=1e3), directory=d)
    hashes = tkv.chain_block_hashes(list(range(2048)), 16)
    d.publish(1, {h: i + 1 for i, h in enumerate(hashes[:64])}, 0.0)
    d.merge(0.0)
    req = tcore.Request(prompt_len=2048, prompt_hashes=hashes)
    _, plan, exposed = router._prefix_terms(rep, req)
    n_bytes = 64 * 16 * cost.model.kv_bytes_per_token
    assert plan is None and exposed == 0.0     # a 1 kB/s link never pays
    router.cost = tcore.CostModel(link_bw=1e15)
    _, plan, exposed = router._prefix_terms(rep, req)
    assert plan is not None and plan.kv_bytes == n_bytes
    assert exposed == pytest.approx(n_bytes / 1e15)


# ---- the KV plane copies --------------------------------------------------------

def _topology_ops(kv, seed):
    rng = np.random.default_rng(seed)
    topo = _topology(kv)
    out = []
    for step in range(200):
        src, dst = (int(x) for x in rng.integers(0, 6, size=2))
        nb = float(rng.integers(1, 1 << 28))
        now = step * 1e-3
        op = int(rng.integers(0, 4))
        if op == 0:
            out.append(("hops", topo.hops(src, dst)))
        elif op == 1:
            out.append(("exposed", topo.exposed_time(nb, src, dst)))
        elif op == 2:
            out.append(("fetch", topo.fetch(nb, src, dst, now)))
        else:
            h = jcl.KVHandoff if kv is jkv else tcl.KVHandoff
            ho = topo.send(h(req=None, kv_tokens=1, src_replica=src,
                             kv_bytes=nb), now, dst)
            out.append(("send", ho.ready_time, ho.transfer_time,
                        ho.dst_replica))
    return out, topo.stats(), dict(topo.busy)


@pytest.mark.parametrize("seed", [0, 1])
def test_link_topology_matches_jax(seed):
    assert _topology_ops(tkv, seed) == _topology_ops(jkv, seed)


def _directory_ops(kv, seed):
    rng = np.random.default_rng(seed)
    d = kv.PrefixDirectory(kv.PrefixDirectoryConfig(
        sync_interval=0.5, advertise_k=6, max_entries=40,
        max_staleness_rounds=2))
    chains = [kv.chain_block_hashes(
        [int(x) for x in rng.integers(0, 40, size=16 * 8)], 16)
        for _ in range(4)]
    out = []
    for step in range(300):
        now = step * 0.1
        rid = int(rng.integers(0, 5))
        chain = chains[int(rng.integers(0, 4))]
        op = int(rng.integers(0, 6))
        if op == 0:
            depth = int(rng.integers(1, 9))
            d.publish(rid, {chain[i]: i + 1 for i in range(depth)}, now)
        elif op == 1:
            d.forget(rid)
        elif op == 2:
            out.append(("due", d.due(now)))
            d.merge(now)
        elif op == 3:
            out.append(("lookup", d.lookup(chain[:int(rng.integers(1, 9))])))
        elif op == 4:
            out.append(("best", d.best_holder(chain, exclude=rid)))
        else:
            out.append(("adv", sorted(d.advertised_replicas())))
        out.append(("epoch", d.epoch))
    return out, d.stats()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_directory_matches_jax(seed):
    got, want = _directory_ops(tkv, seed), _directory_ops(jkv, seed)
    assert any(o[0] == "best" and o[1][0] >= 0 for o in want[0])
    assert got == want


def _req_rows(reqs):
    return [(r.prompt_len, r.arrival_time, r.max_new_tokens, r.session_id,
             tuple(r.prompt_hashes or ())) for r in reqs]


@pytest.mark.parametrize("branch", [0.0, 0.3])
def test_kvplane_workloads_match_jax(branch):
    """SharedPrefixWorkloadSpec, agentic_mix and unique_hashes_for give the
    same requests and block hashes."""
    rows = []
    for kv, core in ((jkv, jcore), (tkv, tcore)):
        spec = kv.SharedPrefixWorkloadSpec(n_sessions=6, turns_per_session=4,
                                           branch_prob=branch, seed=3)
        shared = spec.generate()
        bg = core.WorkloadSpec(n_requests=30, arrival_rate=5.0,
                               seed=4).generate()
        kv.unique_hashes_for(bg, seed=7)
        mixed = kv.agentic_mix(spec, bg)
        rows.append((_req_rows(shared), _req_rows(bg), _req_rows(mixed)))
    assert rows[0] == rows[1]
    assert len(rows[0][2]) == len(rows[0][0]) + len(rows[0][1])


# ---- the cluster simulator ------------------------------------------------------

def _ewsjf(core):
    def make():
        return core.EWSJFScheduler(core.EWSJFConfig(
            min_history=32, reopt_interval=2.0, trial_interval=4.0))
    return make


def _scenario(cl, core, kv):
    """A 4-replica fleet (one a straggler at speed 0.05; radix capped at
    half of each pool, see ``test_uncapped_radix_starves_admission``)
    behind the EWSJF router with admission (tight SLO classes, defer +
    retry), the SLO-burn autoscaler, a policy store, the prefix directory
    and link topology, over shared-
    prefix sessions mixed into an overloading Poisson burst; replica 0
    fails at 0.4 s and a replica is added at 0.6 s.  Returns the run's observable
    decisions."""
    cost = _cost(core, mfu=0.15, hbm_eff=0.7)
    params = cl.ReplicaParams(enable_prefix_cache=True, max_num_seqs=16,
                              kv_pool_tokens=32768, prefix_cache_blocks=1024)
    fleet = [cl.ReplicaModel(i, cost, scheduler=_ewsjf(core)(),
                             params=params, speed=s)
             for i, s in enumerate([1.0, 1.0, 1.0, 0.05])]
    router = cl.EWSJFRouter(cost=cost)
    picks = []
    select = router.select

    def logged(replicas, req, now):
        rep = select(replicas, req, now)
        picks.append((req.request_id, None if rep is None
                      else rep.replica_id, req.cached_len))
        return rep
    router.select = logged
    admission = cl.AdmissionController(
        classes=(cl.SLOClass("interactive", 1.0, 10.0, 2, sheddable=False),
                 cl.SLOClass("standard", 0.3, 4.0, 1),
                 cl.SLOClass("batch", 0.6, None, 0)),
        config=cl.AdmissionConfig(shed_factor=1.0, retry_capacity=16,
                                  retry_backoff=0.2, retry_ttl=1.0))
    asc = cl.SLOBurnAutoscaler(scheduler_factory=_ewsjf(core),
                               cfg=cl.AutoscalerConfig(
                                   max_replicas=7, cooldown_up=0.5,
                                   up_patience=1))
    store = cl.PolicyStore(cl.PolicyStoreConfig(min_fleet_samples=32))
    directory = kv.PrefixDirectory(kv.PrefixDirectoryConfig(
        sync_interval=0.25))
    sim = cl.ClusterSimulator(fleet, router, cost, admission=admission,
                              autoscaler=asc, policy_store=store,
                              topology=_topology(kv),
                              prefix_directory=directory)
    spec = kv.SharedPrefixWorkloadSpec(n_sessions=6, turns_per_session=4,
                                       session_rate=8.0, think_time=0.3,
                                       seed=5)
    bg = core.WorkloadSpec(n_requests=150, arrival_rate=150.0,
                           short_frac=0.5, seed=6).generate()
    kv.unique_hashes_for(bg, seed=11)
    reqs = kv.agentic_mix(spec, bg)
    ids = {id(r): i for i, r in enumerate(sorted(
        reqs, key=lambda r: (r.arrival_time, r.prompt_len)))}
    for r in reqs:
        r.request_id = 30_000 + ids[id(r)]
    res = sim.run(reqs, scenario=[
        cl.ScenarioEvent(time=0.4, action="fail", replica_id=0),
        cl.ScenarioEvent(time=0.6, action="add_replica",
                         scheduler_factory=_ewsjf(core))])
    adm = res.admission
    return {
        "n": len(reqs),
        "finished": [(r.request_id, r.ttft, r.finish_time)
                     for r in res.finished],
        "shed": sorted(r.request_id for r in res.shed),
        "dropped": sorted(r.request_id for r in res.dropped),
        "picks": picks,
        "admission": {k: adm[k] for k in ("shed", "deferred", "readmitted",
                                          "admitted")},
        "autoscale": res.autoscale["events"],
        "policy": res.policy,
        "prefix": res.prefix,
        "health": res.health,
        "reenqueued": res.reenqueued,
        "terminal": res.terminal,
        "total_time": res.total_time,
        "handoff": res.handoff_stats,
    }


@pytest.fixture(scope="module")
def scenario_pair():
    return (_scenario(jcl, jcore, jkv), _scenario(tcl, tcore, tkv))


def test_scenario_exercises_every_plane(scenario_pair):
    """The seeded scenario really fails, drains, scales, sheds, defers,
    syncs the policy store and fetches remote prefixes."""
    want, _ = scenario_pair
    assert want["reenqueued"] > 0
    assert 3 in want["health"]["stragglers"]
    assert any(e[1] == "up" for e in want["autoscale"])
    assert sum(want["admission"]["shed"].values()) > 0
    assert sum(want["admission"]["deferred"].values()) > 0
    assert want["policy"]["merges"] > 0
    assert want["handoff"]["fetches"] > 0
    assert len(want["finished"]) > 50
    assert len(want["finished"]) + len(want["shed"]) + \
        len(want["dropped"]) == want["n"]


@pytest.mark.parametrize("key", ["n", "finished", "shed", "dropped", "picks",
                                 "admission", "autoscale", "policy",
                                 "prefix", "health", "reenqueued",
                                 "terminal", "total_time", "handoff"])
def test_cluster_simulator_matches_jax(scenario_pair, key):
    want, got = scenario_pair
    assert got[key] == want[key]


@pytest.mark.parametrize("cap", [None, 128])
def test_uncapped_radix_starves_admission(cap):
    """A fault of the JAX cluster DES that the copy keeps (parity first):
    with the radix sharing the whole pool (``prefix_cache_blocks=None``)
    its cached blocks are never reclaimed for admission, which budgets on
    ``pool.free_blocks`` alone (``src/repro/cluster/replica.py:519``).
    Four unique 1000-token prompts fill 248 of 256 blocks; the fifth and
    sixth wait for ever and ``run`` returns at its loop guard with them
    WAITING.  A cap of half the pool lets all six finish.  Both packages
    behave alike."""
    out = []
    for cl, core, kv in ((jcl, jcore, jkv), (tcl, tcore, tkv)):
        cost = _cost(core)
        rep = cl.ReplicaModel(0, cost, scheduler=core.FCFSScheduler(),
                              params=cl.ReplicaParams(
                                  enable_prefix_cache=True, max_num_seqs=4,
                                  kv_pool_tokens=4096,
                                  prefix_cache_blocks=cap))
        sim = cl.ClusterSimulator([rep], cl.EWSJFRouter(cost=cost), cost)
        reqs = [core.Request(request_id=i, prompt_len=1000, max_new_tokens=4,
                             arrival_time=0.5 * i) for i in range(6)]
        kv.unique_hashes_for(reqs, seed=1)
        res = sim.run(reqs)
        out.append(([r.request_id for r in res.finished],
                     [r.state.value for r in reqs], rep.pool.free_blocks,
                     rep.radix.cached_blocks))
    assert out[0] == out[1]
    if cap is None:
        assert out[0][0] == [0, 1, 2, 3]
        assert out[0][1][4:] == ["waiting", "waiting"]
        assert out[0][3] == 248
    else:
        assert out[0][0] == list(range(6))


def test_router_comparison_matches_jax():
    """``run_router_comparison`` on one workload: the same TTFT stats per
    router."""
    out = []
    for cl, core in ((jcl, jcore), (tcl, tcore)):
        cost = _cost(core, mfu=0.15, hbm_eff=0.7)
        wl = core.WorkloadSpec(n_requests=150, arrival_rate=30.0,
                               seed=2).generate()
        res = cl.run_router_comparison(
            lambda: cl.make_fleet(3, cost, scheduler_factory=_ewsjf(core)),
            {n: cl.make_router(n, cost)
             for n in ("round_robin", "least_loaded", "ewsjf")}, wl, cost,
            scenario=[cl.ScenarioEvent(time=1.0, action="set_speed",
                                       replica_id=1, speed=0.3)])
        out.append({k: (v.ttft_stats(), v.total_time) for k, v in res.items()})
    assert out[0] == out[1]
