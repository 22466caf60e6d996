"""The port's observability copies (``repro_torch.obs``: trace, metrics,
calibration and the ``Observability`` bundle) against the JAX package's,
and the port's engine instrumentation in the chunked and radix modes.

The copies must behave as the originals on the same stream of emissions,
with one stated exception: ``LogHistogram.percentile`` in the underflow
bucket, a fault of the original that the port repairs.  Engine tests run
the llama2-13b smoke config with bridged weights and numpy-made requests.
"""

import copy
import math

import jax
import numpy as np
import pytest

import repro.core as jcore
import repro.obs as jobs
import repro_torch.core as tcore
import repro_torch.obs as tobs
from repro.configs import get_smoke_config as jax_smoke
from repro.models import init_params as jax_init
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.obs import (DECODE_STEP, PREFILL_CHUNK, LogHistogram,
                             Observability, slo_from_requests)
from repro_torch.obs.trace import LIFECYCLE_KINDS, SPAN_STAGES
from repro_torch.serving import EngineConfig, ServingEngine

ARCH = "llama2-13b"


def _exact_percentile(samples, p):
    s = sorted(samples)
    return s[max(1, math.ceil(p / 100.0 * len(s))) - 1]


# ---- the copies against the originals ------------------------------------------

def _feed(pkg_obs, pkg_core, seed: int):
    """One seeded stream of emissions into an enabled bundle of ``pkg``:
    events, counters, histograms, gauges, calibration pairs and finishes.
    Every histogram value is at or above its spec's ``lo``."""
    obs = pkg_obs.Observability.enabled(calibration=True)
    rng = np.random.default_rng(seed)
    kinds = ("arrival", "dispatch", "chunk", "attach", "promote", "decode",
             "park", "evict")
    for i in range(400):
        kind = kinds[int(rng.integers(0, len(kinds)))]
        obs.event(kind, float(i) * 0.01, request_id=int(rng.integers(0, 20)),
                  replica_id=0, dur=float(rng.random()) * 0.005,
                  data={"slot": int(rng.integers(0, 4))})
        obs.inc("radix_probe_total",
                {"hit": "true" if rng.random() < 0.5 else "false"})
        obs.observe("engine_chunk_width_tokens", float(rng.integers(1, 513)))
        obs.gauge("kv_occupancy", v=float(rng.random()))
        op = (PREFILL_CHUNK, DECODE_STEP, "attach_copy")[i % 3]
        pred = float(rng.uniform(1e-3, 1e-2))
        obs.calibrate(op, pred, pred * float(rng.uniform(0.5, 3.0)))
    for rid in range(12):
        r = pkg_core.Request(request_id=rid, arrival_time=0.0,
                             prompt_len=int(rng.integers(8, 2000)),
                             max_new_tokens=8)
        r.first_token_time = float(rng.uniform(0.01, 2.0))
        r.finish_time = r.first_token_time + float(rng.uniform(0.01, 2.0))
        r.generated = 8
        r.predicted_output = float(rng.integers(2, 20))
        obs.finish(r, r.finish_time, replica_id=0)
    return obs


@pytest.mark.parametrize("seed", [0, 1])
def test_obs_copies_match_jax_on_one_stream(seed):
    jo, to = _feed(jobs, jcore, seed), _feed(tobs, tcore, seed)
    assert to.snapshot() == jo.snapshot()
    assert to.trace.to_chrome_trace() == jo.trace.to_chrome_trace()
    assert to.calib.correction() == jo.calib.correction()
    for rid in range(20):
        assert to.trace.stage_breakdown(rid) == jo.trace.stage_breakdown(rid)


def test_trace_taxonomy_copied():
    assert SPAN_STAGES == jobs.trace.SPAN_STAGES
    assert LIFECYCLE_KINDS == jobs.trace.LIFECYCLE_KINDS
    assert SPAN_STAGES["chunk"] == "prefill" and SPAN_STAGES["attach"] == "attach"


# ---- LogHistogram.percentile below lo ----------------------------------------------

def test_underflow_percentile_jax_fault_and_port_repair():
    """One sample of 1e-5 (under ``lo`` = 1e-4): the JAX copy reports the
    bucket's edge 1e-4, ten times the sample and outside its own stated
    bound; the port reports the sample, as its docstring states."""
    jh, th = jobs.LogHistogram(), LogHistogram()
    jh.observe(1e-5)
    th.observe(1e-5)
    assert jh.percentile(50) == pytest.approx(1e-4)
    assert jh.percentile(50) > 1e-5 * jh.spec.growth      # the broken bound
    assert th.percentile(50) == 1e-5


@pytest.mark.parametrize("seed", range(6))
def test_port_percentile_keeps_its_stated_bound(seed):
    """Log-uniform samples from 1e-7 to 500 (so some land under ``lo`` and
    some in overflow): above ``lo`` the estimate is within one bucket of the
    exact percentile; in the underflow bucket it lies between the exact
    value and the bucket's largest sample; in overflow it is the max."""
    rng = np.random.default_rng(seed)
    samples = list(np.exp(rng.uniform(math.log(1e-7), math.log(500.0),
                                      size=int(rng.integers(1, 200)))))
    h = LogHistogram()
    for v in samples:
        h.observe(v)
    spec = h.spec
    top = spec.lo * spec.growth ** (spec.n_buckets - 1)
    under = [v for v in samples if v <= spec.lo]
    for p in (1, 10, 50, 90, 95, 99, 100):
        exact, est = _exact_percentile(samples, p), h.percentile(p)
        if exact > top:
            assert est == max(samples)
        elif exact <= spec.lo:
            assert exact <= est <= max(under) <= spec.lo
        else:
            assert exact <= est * (1 + 1e-9)
            assert est <= exact * spec.growth * (1 + 1e-9)


def test_port_underflow_within_growth_when_samples_are_close():
    """Underflow samples within a factor ``growth`` of each other keep the
    growth bound; merge and copy carry the underflow maximum."""
    a, b = LogHistogram(), LogHistogram()
    for v in (3e-5, 4e-5):
        a.observe(v)
    b.observe(5e-5)
    b.observe(1.0)
    merged = a.copy().merge(b)
    assert merged.under_max == 5e-5 and a.under_max == 4e-5
    for p in (10, 50, 75):
        exact = _exact_percentile([3e-5, 4e-5, 5e-5, 1.0], p)
        assert exact <= merged.percentile(p) <= exact * merged.spec.growth


# ---- the engine's instrumentation ------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    """(JAX config, port config, JAX params, port params)."""
    jcfg, tcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    return jcfg, tcfg, jp, tp


def _requests(pkg, vocab, n=6, seed=0, max_new=6, prefix_tokens=0):
    """The requests of tests/test_engine_obs.py, in ``pkg``."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=(prefix_tokens,)).astype(np.int32)
    out = []
    for i in range(n):
        pl = 64 + 16 * (i % 3)
        toks = rng.integers(0, vocab, size=(pl,)).astype(np.int32)
        if prefix_tokens:
            toks[:prefix_tokens] = shared
        r = pkg.Request(request_id=i, arrival_time=0.0, prompt_len=pl,
                        max_new_tokens=max_new, prompt_tokens=toks)
        r.predicted_output = float(max_new)
        out.append(r)
    return out


def _engine(weights, obs=None, chunk=32, radix=False, jax_side=False):
    jcfg, tcfg, jp, tp = weights
    ecfg = dict(max_slots=4, s_max=256, kv_pool_tokens=16384,
                chunk_prefill_tokens=chunk, enable_prefix_cache=radix)
    if jax_side:
        return JaxEngine(jcfg, jp, jcore.FCFSScheduler(),
                         JaxEngineConfig(**ecfg), obs=obs)
    return ServingEngine(tcfg, tp, tcore.FCFSScheduler(), EngineConfig(**ecfg),
                         obs=obs, device="cpu")


@pytest.mark.parametrize("chunk,radix", [(32, False), (None, True),
                                         (32, True)])
def test_sampled_tokens_identical_obs_on_off(weights, chunk, radix):
    """A fully enabled calibration bundle moves no sampled token, in the
    chunked, radix and chunked+radix modes."""
    base = _requests(tcore, weights[1].vocab_size, n=5, seed=3,
                     prefix_tokens=48 if radix else 0)
    eng_off = _engine(weights, None, chunk, radix)
    eng_off.run(copy.deepcopy(base), max_steps=4000)
    eng_on = _engine(weights, Observability.enabled(calibration=True), chunk,
                     radix)
    eng_on.run(copy.deepcopy(base), max_steps=4000)
    assert eng_off.output_tokens == eng_on.output_tokens
    assert len(eng_on.finished) == len(base)


@pytest.fixture(scope="module")
def traced(weights):
    """The port and the JAX engine in chunked+radix mode, both traced with
    calibration on, over the same requests."""
    out = {}
    for side in ("port", "jax"):
        pkg = jcore if side == "jax" else tcore
        obs = (jobs if side == "jax" else tobs).Observability.enabled(
            calibration=True)
        eng = _engine(weights, obs, chunk=32, radix=True,
                      jax_side=side == "jax")
        eng.run(_requests(pkg, weights[1].vocab_size, n=6, seed=2, max_new=8,
                          prefix_tokens=48), max_steps=4000)
        out[side] = (eng, obs)
    return out


def test_span_causality_and_slot_tracks(traced):
    """Chunk spans nest inside dispatch → first_token; the attach span
    precedes the slot's promote; engine spans carry slot tracks."""
    eng, obs = traced["port"]
    assert len(eng.finished) == 6
    for rid in range(6):
        by_kind: dict = {}
        for e in obs.trace.request_events(rid):
            by_kind.setdefault(e.kind, []).append(e)
        t_disp = by_kind["dispatch"][0].t
        t_first = by_kind["first_token"][0].t
        chunks = by_kind.get("chunk", []) + by_kind.get("recompute", [])
        assert chunks, f"request {rid}: no chunk spans"
        for c in chunks:
            assert t_disp <= c.t and c.t + c.dur <= t_first + 1e-6
            assert "slot" in c.data
        assert by_kind["promote"][0].t <= t_first + 1e-9
        if "attach" in by_kind:
            assert by_kind["attach"][0].t <= by_kind["promote"][0].t
    kinds = {e[1] for e in obs.trace.events}
    assert "attach" in kinds and "park" in kinds


def test_event_sequences_match_jax(traced):
    """Per request, the port emits the JAX engine's lifecycle and span
    kinds in the same order, with the same chunk positions and widths and
    the same attached blocks."""
    (teng, tobs_), (jeng, jobs_) = traced["port"], traced["jax"]

    def seq(obs, rid):
        return [(e.kind, *((e.data or {}).get(k) for k in
                           ("pos", "chunk", "blocks", "cached_tokens")))
                for e in obs.trace.request_events(rid)]
    for rid in range(6):
        assert seq(tobs_, rid) == seq(jobs_, rid)
    assert teng.output_tokens == jeng.output_tokens


def test_calibrator_samples_and_metric_keys(traced):
    """The run fed the prefill and decode fits and every metric the JAX
    engine records on these paths; the predictor view saw every finish."""
    (_, tobs_), (_, jobs_) = traced["port"], traced["jax"]
    for op in (PREFILL_CHUNK, DECODE_STEP):
        assert tobs_.calib.samples(op) > 0, op
    assert tobs_.calib.samples("attach_copy") > 0
    assert tobs_.pred_calib.observed == 6
    snap, jsnap = tobs_.metrics.snapshot(), jobs_.metrics.snapshot()
    for section in ("counters", "histograms"):
        assert set(snap[section]) == set(jsnap[section]), section
    assert "engine_compile_cache_total" in snap["counters"]
    assert "radix_probe_total" in snap["counters"]
    assert "engine_chunk_width_tokens" in snap["histograms"]
    assert "radix_attach_copy_bytes" in snap["histograms"]


def test_heartbeat_carries_metrics(weights):
    obs = Observability.enabled()
    eng = _engine(weights, obs, chunk=32, radix=False)
    eng.run(_requests(tcore, weights[1].vocab_size, n=3, seed=4),
            max_steps=4000)
    hb = eng.heartbeat()
    assert hb["finished"] == 3 and hb["tokens_out"] == 3 * 6
    assert hb["prefilling"] == 0 and "metrics" in hb
    assert hb["kv_occupancy"] == pytest.approx(eng.pool.utilization)


def test_engine_slo_report_one_code_path(weights):
    """slo_report gives per-class percentiles from the live registry and
    from the request-side fallback, agreeing on counts."""
    obs = Observability.enabled()
    eng = _engine(weights, obs, chunk=32)
    eng.run(_requests(tcore, weights[1].vocab_size, n=4, seed=5),
            max_steps=4000)
    live = eng.slo_report()
    recomputed = slo_from_requests(eng.finished, obs.classify)
    assert live["_all"]["ttft"]["n"] == recomputed["_all"]["ttft"]["n"]
    eng2 = _engine(weights, None, chunk=32)
    eng2.run(_requests(tcore, weights[1].vocab_size, n=4, seed=5),
             max_steps=4000)
    rep = eng2.slo_report()
    assert rep and rep["_all"]["ttft"]["n"] == 4
    assert eng2.stats()["slo"] == rep
