"""The port's copies of the discrete-event simulator (``core/simulator.py``)
and of the prediction plane (``predict/``) against the JAX package's, on
seeded inputs.

The port's ``CostModel`` defaults to one H100's data-sheet peaks; every
parity run here gives it the JAX package's v5e constants, so both sides
price the same steps and the results must be equal, not close."""

import copy

import pytest

import repro.core as jcore
import repro.predict as jpred
import repro_torch.core as tcore
import repro_torch.predict as tpred

V5E = dict(peak_flops=197e12, hbm_bw=819e9, n_chips=4)   # repro cost_model:24-27


def _cost(pkg):
    return pkg.CostModel(**V5E) if pkg is tcore else pkg.CostModel()


def _sched(pkg, name):
    if name == "fcfs":
        return pkg.FCFSScheduler()
    if name == "sjf":
        return pkg.SJFScheduler()
    return pkg.EWSJFScheduler(pkg.EWSJFConfig(min_history=16,
                                              reopt_interval=1.0),
                              _cost(pkg))


def _trace(pkg, seed: int, n: int = 300):
    """A seeded Poisson mixed trace with explicit ids, in ``pkg``."""
    base = pkg.WorkloadSpec(n_requests=n, arrival_rate=30.0, seed=seed,
                            mean_output_tokens=80).generate()
    for i, r in enumerate(base):
        r.request_id = 10_000 + i
    return base


def _params(pkg, **kw):
    return pkg.EngineParams(max_num_seqs=16, max_prefill_tokens=4096,
                            kv_pool_tokens=8192, decode_steps_per_tick=4,
                            **kw)


def _summary(res):
    return ([r.request_id for r in res.finished],
            [r.ttft for r in res.finished],
            [r.finish_time for r in res.finished],
            [r.request_id for r in res.aborted],
            (res.total_time, res.preemptions, res.ticks,
             res.padded_prefill_tokens, res.real_prefill_tokens,
             res.busy_time))


@pytest.mark.parametrize("name", ["fcfs", "sjf", "ewsjf"])
@pytest.mark.parametrize("timeout", [None, 2.0])
def test_des_matches_jax(name, timeout):
    """One seeded trace through both simulators: the same finished order,
    TTFTs, finish times, aborts, dispatch log and counters (a small pool,
    so recompute preemptions run too)."""
    out = {}
    for pkg in (jcore, tcore):
        log = []
        sim = pkg.ServingSimulator(
            _sched(pkg, name), _cost(pkg), _params(pkg, ttft_timeout=timeout),
            on_dispatch=lambda reqs, t, log=log: log.append(
                (t, [r.request_id for r in reqs])))
        out[pkg] = (_summary(sim.run(_trace(pkg, seed=3))), log)
    (jsum, jlog), (tsum, tlog) = out[jcore], out[tcore]
    assert len(jsum[0]) + len(jsum[3]) == 300
    assert tsum == jsum
    assert tlog == jlog
    assert jsum[4][1] > 0 or timeout is not None   # preemptions ran


def test_run_comparison_matches_jax():
    """``run_comparison`` over FCFS, SJF and EWSJF on one WorkloadSpec:
    every result's counters and TTFT statistics equal."""
    res = {}
    for pkg in (jcore, tcore):
        spec = pkg.WorkloadSpec(n_requests=200, arrival_rate=25.0, seed=5)
        res[pkg] = pkg.run_comparison(
            {n: _sched(pkg, n) for n in ("fcfs", "sjf", "ewsjf")}, spec,
            _cost(pkg), _params(pkg))
    for name in ("fcfs", "sjf", "ewsjf"):
        j, t = res[jcore][name], res[tcore][name]
        assert t.ttft_stats() == j.ttft_stats()
        assert (t.total_time, t.tok_per_s, t.padding_waste, t.utilization,
                t.abort_rate) == (j.total_time, j.tok_per_s,
                                  j.padding_waste, j.utilization,
                                  j.abort_rate)
        assert [r.prompt_len for r in t.finished] == \
            [r.prompt_len for r in j.finished]


def test_uniform_workload_matches_jax():
    a = jcore.uniform_workload(50, 32, 256, 10.0, seed=2)
    b = tcore.uniform_workload(50, 32, 256, 10.0, seed=2)
    assert [(r.prompt_len, r.arrival_time, r.max_new_tokens) for r in a] == \
        [(r.prompt_len, r.arrival_time, r.max_new_tokens) for r in b]


# ---- the prediction plane -----------------------------------------------------

def _heavy_tail(pkg, **kw):
    spec = pkg.HeavyTailDecodeSpec(n_requests=400, n_sessions=24, seed=9,
                                   **kw)
    reqs = spec.generate()
    for i, r in enumerate(reqs):
        r.request_id = 20_000 + i
    return spec, reqs


@pytest.mark.parametrize("kw", [{}, {"drift_time": 15.0},
                                {"adversarial": True}])
def test_heavy_tail_spec_samples_match_jax(kw):
    (js, jr), (ts, tr) = _heavy_tail(jpred, **kw), _heavy_tail(tpred, **kw)
    assert [(r.prompt_len, r.arrival_time, r.max_new_tokens, r.session_id)
            for r in jr] == [(r.prompt_len, r.arrival_time,
                              r.max_new_tokens, r.session_id) for r in tr]
    assert ts.tail_fraction() == js.tail_fraction()


def _lp(p):
    """A LengthPrediction as a plain tuple (the two packages' classes
    differ, so their instances never compare equal)."""
    return None if p is None else (p.expected, p.p50, p.p90, p.n)


def _predict_stream(pkg, pred_pkg):
    """Feed one seeded session stream through an empirical and an oracle
    predictor; record every prediction, stamp and remaining-work value."""
    _, reqs = _heavy_tail(pred_pkg)
    cost = _cost(pkg)
    emp = pred_pkg.EmpiricalLengthPredictor(min_obs=4, cap=64, recent=8,
                                            cost=cost)
    orc = pred_pkg.OracleNoisePredictor(sigma=0.5, bias=-0.2, seed=3,
                                        cost=cost)
    out = []
    for i, r in enumerate(reqs):
        now = r.arrival_time
        p = _lp(emp.predict(r, now))
        o = _lp(orc.predict(r, now))
        emp.annotate(r, now)
        out.append((p, o, r.predicted_output, r.predicted_extra,
                    emp.remaining_work(r, i % 7),
                    orc.remaining_work(r, i % 5)))
        r.generated = r.max_new_tokens
        if i % 3 != 2:          # some requests finish before the next query
            emp.observe(r, now)
    return out, emp.export_state()


def test_predictors_match_jax_on_one_stream():
    """Predictions, stamps, remaining work and the exported posterior of
    the empirical and the oracle predictor are equal on one stream."""
    jout, jstate = _predict_stream(jcore, jpred)
    tout, tstate = _predict_stream(tcore, tpred)
    assert sum(p is not None for p, *_ in jout) > 100
    assert tout == jout
    assert tstate == jstate
    assert tpred.merge_states([tstate, tstate], per_key_cap=32) == \
        jpred.merge_states([jstate, jstate], per_key_cap=32)


@pytest.mark.parametrize("eos", [1e-9, 0.01, 0.2, 1.0])
def test_gittins_and_work_extra_match_jax(eos):
    assert tpred.gittins_index(eos, horizon=9) == \
        jpred.gittins_index(eos, horizon=9)
    for out, pl in ((0.0, 100.0), (17.0, 64.0), (300.0, 2000.0)):
        assert tpred.work_equivalent_extra(out, pl, _cost(tcore), 16) == \
            jpred.work_equivalent_extra(out, pl, _cost(jcore), 16)
        assert tpred.work_equivalent_extra(out, pl) == \
            jpred.work_equivalent_extra(out, pl)


def test_merged_state_feeds_a_cold_predictor_alike():
    _, jstate = _predict_stream(jcore, jpred)
    _, tstate = _predict_stream(tcore, tpred)
    jp, tp = jpred.EmpiricalLengthPredictor(), tpred.EmpiricalLengthPredictor()
    jp.merge_state(jstate)
    tp.merge_state(tstate)
    _, jr = _heavy_tail(jpred)
    _, tr = _heavy_tail(tpred)
    got = [_lp(tp.predict(r, 0.0)) for r in tr[:50]]
    assert got == [_lp(jp.predict(r, 0.0)) for r in jr[:50]]
    assert any(g is not None for g in got)


def _drive_predicted(pkg, pred_pkg, ticks: int = 200, dt: float = 0.1):
    """EWSJF with an empirical predictor wired in: arrivals are stamped at
    ingest, finishes observed; returns the dispatched ids per tick."""
    _, reqs = _heavy_tail(pred_pkg)
    cost = _cost(pkg)
    pred = pred_pkg.EmpiricalLengthPredictor(min_obs=4, cost=cost)
    sched = pkg.EWSJFScheduler(pkg.EWSJFConfig(min_history=16,
                                               reopt_interval=1.5,
                                               trial_interval=3.0), cost)
    sched.predictor = pred
    stamped = 0
    plans, pi = [], 0
    for k in range(ticks):
        now = k * dt
        while pi < len(reqs) and reqs[pi].arrival_time <= now:
            pred.annotate(reqs[pi], now)
            stamped += reqs[pi].predicted_output is not None
            sched.submit(reqs[pi], now=now)
            pi += 1
        sched.maybe_reoptimize(now)
        plan = sched.tick(now, pkg.BatchBudget(max_requests=4,
                                               max_tokens=2048,
                                               kv_blocks_free=256,
                                               block_size=16))
        plans.append([r.request_id for r in plan.requests])
        for r in plan.requests:
            r.first_token_time = now + 0.02
            r.generated = r.max_new_tokens
            r.finish_time = now + 0.05
            sched.on_finish(r, r.finish_time)
            pred.observe(r, r.finish_time)
    assert stamped > 20                     # the predictor really spoke
    return plans, sched


def test_ewsjf_with_predictor_plans_match_jax():
    jplans, jsched = _drive_predicted(jcore, jpred)
    tplans, tsched = _drive_predicted(tcore, tpred)
    assert sum(len(p) for p in jplans) > 100
    for k, (a, b) in enumerate(zip(jplans, tplans)):
        assert a == b, f"tick {k}: JAX {a} vs port {b}"
    assert jsched.reopt_count >= 2
    assert tsched.export_observation()["predictor"] == \
        jsched.export_observation()["predictor"]


def test_des_copy_sits_in_the_port_core():
    """The simulator is exported from the port's ``core`` as from JAX's."""
    for name in ("EngineParams", "ServingSimulator", "SimResult",
                 "WorkloadSpec", "run_comparison", "uniform_workload"):
        assert name in tcore.__all__ and hasattr(tcore, name)
    sim = tcore.ServingSimulator(tcore.FCFSScheduler(), tcore.CostModel())
    res = sim.run(copy.deepcopy(_trace(tcore, seed=1, n=20)))
    assert len(res.finished) == 20 and res.total_time > 0
