"""The port's DES↔engine replay harness (``repro_torch.serving.replay``) and
its CLI (``repro_torch.launch.replay_trace``) against the JAX package's
``serving/replay.py`` and ``tools/replay_trace.py``, on the CPU.

Both sides replay the same burst trace: the JAX engine on its PRNGKey(0)
weights, the port's engine on those weights bridged, in f32.  The DES is
priced with the v5e constants on both sides (the port's ``CostModel``
defaults to one H100's peaks), so the DES sides must be identical; the
engine sides must dispatch alike under the wall-clock-free schedulers."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.serving.replay as jrep
import repro_torch.serving.replay as trep
from repro.configs import get_smoke_config as jax_smoke
from repro.models import init_params as jax_init
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import CostModel

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llama2-13b"
V5E = dict(peak_flops=197e12, hbm_bw=819e9, n_chips=4)   # repro cost_model:24-27
PORT_ONLY_KEYS = {"engine_tokens", "engine_tok_per_s", "engine_elapsed_s"}


@pytest.mark.parametrize("kw", [dict(n=12, seed=0), dict(n=20, seed=3),
                                dict(n=16, seed=1, vocab_size=32000,
                                     short=(16, 128), long=(700, 1900),
                                     long_frac=0.25, out_range=(8, 33))])
def test_burst_trace_matches_jax(kw):
    a, b = jrep.burst_trace(**kw), trep.burst_trace(**kw)
    assert [(r.request_id, r.prompt_len, r.max_new_tokens, r.arrival_time)
            for r in a] == [(r.request_id, r.prompt_len, r.max_new_tokens,
                             r.arrival_time) for r in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.prompt_tokens, y.prompt_tokens)


@pytest.mark.parametrize("seed", range(4))
def test_kendall_tau_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = list(rng.permutation(15))
    b = list(rng.permutation(15))
    c = [x for x in b if x % 3] + [99]               # partial overlap
    for x, y in ((a, b), (a, a), (a, a[::-1]), (a, c), ([1], [1]),
                 ([], [2])):
        assert trep.kendall_tau(x, y) == jrep.kendall_tau(x, y)
    assert trep.kendall_tau(a, a) == 1.0
    assert trep.kendall_tau(a, a[::-1]) == -1.0


def test_harness_constants_match_jax():
    assert trep.SCHEDULERS == jrep.SCHEDULERS
    assert trep.EXACT_SCHEDULERS == jrep.EXACT_SCHEDULERS
    assert trep.TAU_BOUND == jrep.TAU_BOUND == 0.6


@pytest.fixture(scope="module")
def suites():
    """The JAX suite (its own weights) and the port's (the same weights,
    bridged; v5e DES) over burst_trace(n=8, seed=0)."""
    jcfg, tcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    js = jrep.run_suite(n=8, seed=0, arch=ARCH)
    ts = trep.run_suite(n=8, seed=0, arch=ARCH, cfg=tcfg, params=tp,
                        device="cpu", cost=CostModel(**V5E))
    return js, ts


@pytest.mark.parametrize("i", range(3))
def test_run_replay_matches_jax(suites, i):
    """Per scheduler: identical DES sides, engine dispatch equal to JAX's
    under FCFS and SJF, and ``replay_ok`` on both."""
    js, ts = suites
    j, t = js["reports"][i], ts["reports"][i]
    assert t["scheduler"] == j["scheduler"] == trep.SCHEDULERS[i]
    for key in ("des_dispatch", "des_ttft", "des_finished", "n_requests",
                "exact_required", "tau_bound", "arch"):
        assert t[key] == j[key], key
    if t["exact_required"]:
        assert t["engine_dispatch"] == j["engine_dispatch"]
        assert t["dispatch_match"] and j["dispatch_match"]
    assert t["engine_finished"] == j["engine_finished"] == 8
    assert trep.replay_ok(t) and jrep.replay_ok(j)
    assert set(t) == set(j) | PORT_ONLY_KEYS
    assert sorted(map(int, t["engine_tokens"])) == list(range(8))


def test_suites_agree(suites):
    js, ts = suites
    assert {k: v for k, v in ts.items() if k != "reports"} == \
        {k: v for k, v in js.items() if k != "reports"}
    assert ts["ok"]


def test_replay_ok_criterion_matches_jax():
    """The pass criterion on hand-made reports, both ways round."""
    base = dict(n_requests=4, des_finished=4, engine_finished=4,
                exact_required=True, dispatch_match=True, dispatch_tau=1.0,
                tau_bound=0.6)
    cases = [base, {**base, "dispatch_match": False},
             {**base, "engine_finished": 3}, {**base, "des_finished": 3},
             {**base, "exact_required": False, "dispatch_match": False,
              "dispatch_tau": 0.61},
             {**base, "exact_required": False, "dispatch_tau": 0.59}]
    assert [trep.replay_ok(c) for c in cases] == \
        [jrep.replay_ok(c) for c in cases] == \
        [True, False, False, False, True, False]


def test_replay_trace_cli_writes_the_jax_report_keys(tmp_path, suites):
    """``python -m repro_torch.launch.replay_trace --quick --device cpu
    --json PATH`` exits 0 and writes the JAX tool's report: its top-level
    keys, and in every report the JAX keys plus the engine's tokens and
    rate."""
    js, _ = suites
    out = tmp_path / "replay.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.replay_trace", "--quick",
         "--device", "cpu", "--json", str(out)],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "replay equivalence: arch=llama2-13b n=8 seed=0" in run.stdout
    got = json.loads(out.read_text())
    assert set(got) == set(js)
    assert got["n_requests"] == 8 and got["ok"]
    assert [r["scheduler"] for r in got["reports"]] == list(trep.SCHEDULERS)
    for r, j in zip(got["reports"], js["reports"]):
        assert set(r) == set(j) | PORT_ONLY_KEYS
