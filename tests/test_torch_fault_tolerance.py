"""The port's copy of the legacy multi-pod controller
(``repro_torch.distributed.ClusterController``): twins of
``tests/test_fault_tolerance.py`` (failure recovery, stragglers,
elasticity, state round trip) on the port's copies of ``core/`` and
``cluster/``, and the port's controller against the JAX package's on the
same requests, with the JAX package's v5e cost constants passed to the
port's ``CostModel`` (whose defaults are H100 peaks)."""

import numpy as np
import pytest

import repro.core as jcore
import repro.distributed as jdist
import repro_torch.core as tcore
import repro_torch.distributed as tdist
from repro_torch.core import CostModel, EWSJFConfig, EWSJFScheduler, Request
from repro_torch.distributed import ClusterConfig, ClusterController

V5E = dict(peak_flops=197e12, hbm_bw=819e9, n_chips=4)   # repro cost_model:24-27


def mk(n_pods=3):
    sched = EWSJFScheduler(EWSJFConfig(min_history=8))
    return ClusterController(sched, CostModel(),
                             ClusterConfig(n_pods=n_pods,
                                           max_inflight_per_pod=16))


def submit(ctl, n=40, seed=0, pkg=tcore):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        ctl.sched.submit(pkg.Request(prompt_len=int(rng.integers(32, 2048))),
                         now=ctl.now)


def drive(ctl, rounds=60, dt=2.0, fail_at=None, fail_pod=0):
    for i in range(rounds):
        ctl.route_step()
        if fail_at is not None and i == fail_at:
            ctl.remove_pod(fail_pod, graceful=False)
        ctl.advance(dt)
        ctl.check_health()


def test_exports_only_the_controller():
    """The port's ``distributed`` exports the controller, its config and
    ``PodState``; sharding comes with a later step."""
    assert sorted(tdist.__all__) == ["ClusterConfig", "ClusterController",
                                     "PodState"]
    assert set(tdist.__all__) < set(jdist.__all__)


def test_pod_failure_requeues_inflight():
    ctl = mk()
    submit(ctl, 40)
    drive(ctl, fail_at=3)
    assert len(ctl.finished) == 40            # no request lost
    assert ctl.reenqueued > 0                 # recovery actually happened
    assert sum(p.alive for p in ctl.pods.values()) == 2


def test_straggler_detected_and_drained():
    ctl = mk(n_pods=4)
    ctl.pods[2].speed = 0.05                  # 20x slower
    submit(ctl, 60)
    drive(ctl, rounds=160)
    assert len(ctl.finished) == 60
    assert not ctl.pods[2].alive or ctl.pods[2].draining


def test_elastic_scale_up_absorbs_load():
    ctl = mk(n_pods=1)
    submit(ctl, 60)
    for _ in range(10):
        ctl.route_step()
        ctl.advance(2.0)
    ctl.add_pod(speed=1.0)
    ctl.add_pod(speed=1.0)
    # second wave after scale-up: the new pods must absorb it
    submit(ctl, 60, seed=1)
    drive(ctl, rounds=80)
    assert len(ctl.finished) == 120
    assert sum(p.served > 0 for p in ctl.pods.values()) >= 2


def test_controller_state_roundtrip(tmp_path):
    ctl = mk()
    submit(ctl, 20)
    ctl.sched.maybe_reoptimize(1.0, force=True)
    path = tmp_path / "ctl.json"
    ctl.save_state(path)
    ctl2 = mk()
    ctl2.load_state(path)
    assert ctl2.sched.waiting() == ctl.sched.waiting()
    b1 = [(q.bounds.lo, q.bounds.hi) for q in ctl.sched.manager.queues]
    b2 = [(q.bounds.lo, q.bounds.hi) for q in ctl2.sched.manager.queues]
    assert b1 == b2


def _run(pkg, dist, cost, scenario):
    sched = pkg.EWSJFScheduler(pkg.EWSJFConfig(min_history=8))
    ctl = dist.ClusterController(sched, cost, dist.ClusterConfig(
        n_pods=4 if scenario == "straggler" else 3,
        max_inflight_per_pod=16))
    if scenario == "straggler":
        ctl.pods[2].speed = 0.05
    submit(ctl, 50, seed=3, pkg=pkg)
    if scenario == "scale_up":
        for _ in range(5):
            ctl.route_step()
            ctl.advance(2.0)
        ctl.add_pod(speed=0.5)
        submit(ctl, 30, seed=4, pkg=pkg)
    drive(ctl, rounds=160 if scenario == "straggler" else 80,
          fail_at=3 if scenario == "failure" else None)
    return ctl


@pytest.mark.parametrize("scenario", ["failure", "straggler", "scale_up"])
def test_port_controller_matches_jax(scenario):
    """The same requests and events through both controllers: the same
    requests finish in the same order at the same times, as many are
    re-enqueued, and each pod ends alive or not, draining or not, having
    served as many."""
    jctl = _run(jcore, jdist, jcore.CostModel(), scenario)
    tctl = _run(tcore, tdist, tcore.CostModel(**V5E, link_bw=50e9), scenario)
    assert len(tctl.finished) == len(jctl.finished) > 0

    def trace(ctl):
        return [(r.prompt_len, r.finish_time) for r in ctl.finished]
    assert trace(tctl) == trace(jctl)
    assert tctl.reenqueued == jctl.reenqueued
    assert tctl.now == jctl.now
    assert {i: (p.alive, p.draining, p.served) for i, p in tctl.pods.items()} \
        == {i: (p.alive, p.draining, p.served) for i, p in jctl.pods.items()}


def test_port_cost_model_defaults_change_only_the_clock():
    """With its H100 defaults the port's controller still finishes every
    request of the failure scenario, sooner by the roofline than at the
    v5e constants."""
    fast = _run(tcore, tdist, tcore.CostModel(), "failure")
    slow = _run(tcore, tdist, tcore.CostModel(**V5E, link_bw=50e9),
                "failure")
    assert len(fast.finished) == len(slow.finished) == 50
    assert max(r.finish_time for r in fast.finished) < \
        max(r.finish_time for r in slow.finished)


def test_request_type_is_the_ports():
    """The controller's pods take the port's own ``Request``."""
    ctl = mk(n_pods=1)
    ctl.sched.submit(Request(prompt_len=64), now=0.0)
    drive(ctl, rounds=5)
    assert len(ctl.finished) == 1
    assert isinstance(ctl.finished[0], Request)
