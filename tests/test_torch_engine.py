"""The PyTorch port's ServingEngine on the CPU, against the JAX engine.

Both engines serve llama2-13b smoke weights (JAX-initialized, bridged to the
port) with identical request ids, prompt lengths and token budgets.  Greedy
tokens, dispatch order and ``BlockPool`` accounting must agree.  The mamba2
smoke config is held the same way where the JAX engine is right (one prompt
length), and per request against a JAX engine that prefills one request at
a time where it is not (mixed lengths: it folds a shorter row's padding
into that row's state).
"""

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.configs import get_smoke_config as jax_smoke
from repro.models import init_params as jax_init
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.serving import EngineConfig, ServingEngine

ARCH = "llama2-13b"
ECFG = dict(max_slots=4, s_max=128, kv_pool_tokens=2048,
            buckets=(32, 64, 128))


@pytest.fixture(scope="module")
def weights():
    """(JAX config, port config, JAX params, port params)."""
    jcfg, tcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    return jcfg, tcfg, jp, tp


def _specs(n: int, seed: int):
    """(prompt_len, max_new_tokens) pairs: 70% short, 30% long prompts."""
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(6, 30) if rng.random() < 0.7
                 else rng.integers(60, 110)), int(rng.integers(2, 7)))
            for _ in range(n)]


def _requests(pkg, specs, vocab: int, explicit_tokens: bool):
    reqs = []
    for i, (ln, new) in enumerate(specs):
        r = pkg.Request(prompt_len=ln, arrival_time=0.0, max_new_tokens=new,
                        request_id=90_000 + i)
        if explicit_tokens:
            r.prompt_tokens = ((np.arange(ln) * 7 + i) % vocab).astype(np.int32)
        reqs.append(r)
    return reqs


def _scheduler(pkg, name: str):
    if name == "ewsjf":
        return pkg.EWSJFScheduler(pkg.EWSJFConfig(min_history=8,
                                                  reopt_interval=0.2))
    return {"fcfs": pkg.FCFSScheduler, "sjf": pkg.SJFScheduler}[name]()


def _run_both(weights, name: str, specs, *, explicit_tokens=False, **ecfg):
    jcfg, tcfg, jp, tp = weights
    cfg = {**ECFG, **ecfg}
    jeng = JaxEngine(jcfg, jp, _scheduler(jcore, name), JaxEngineConfig(**cfg))
    teng = ServingEngine(tcfg, tp, _scheduler(tcore, name),
                         EngineConfig(**cfg), device="cpu")
    jfin = jeng.run(_requests(jcore, specs, jcfg.vocab_size, explicit_tokens),
                    max_steps=4000)
    tfin = teng.run(_requests(tcore, specs, jcfg.vocab_size, explicit_tokens),
                    max_steps=4000)
    assert len(jfin) == len(tfin) == len(specs)
    return jeng, teng


@pytest.fixture(scope="module")
def fcfs_pair(weights):
    return _run_both(weights, "fcfs", _specs(12, seed=0))


def test_fcfs_greedy_tokens_equal(fcfs_pair):
    jeng, teng = fcfs_pair
    assert teng.output_tokens == jeng.output_tokens
    assert all(len(v) > 1 for v in teng.output_tokens.values())


def test_fcfs_dispatch_order_equal(fcfs_pair):
    jeng, teng = fcfs_pair
    assert [rid for _, rid in teng.dispatch_log] == \
        [rid for _, rid in jeng.dispatch_log]
    assert teng.prefill_batches == jeng.prefill_batches
    assert teng.stats()["padding_waste"] == jeng.stats()["padding_waste"]


def test_block_pool_counts_equal(fcfs_pair):
    jeng, teng = fcfs_pair
    for attr in ("total_blocks", "block_size", "free_blocks", "allocs"):
        assert getattr(teng.pool, attr) == getattr(jeng.pool, attr)
    assert teng.pool.free_blocks == teng.pool.total_blocks


def test_sjf_dispatch_order_equal(weights):
    jeng, teng = _run_both(weights, "sjf", _specs(10, seed=1))
    assert [rid for _, rid in teng.dispatch_log] == \
        [rid for _, rid in jeng.dispatch_log]
    assert teng.output_tokens == jeng.output_tokens


def test_ewsjf_greedy_tokens_equal(weights):
    """EWSJF re-optimises on the wall clock, so the two engines may batch
    differently; with explicit prompt tokens every request's greedy tokens
    are independent of batching and must agree."""
    jeng, teng = _run_both(weights, "ewsjf", _specs(12, seed=2),
                           explicit_tokens=True)
    assert teng.output_tokens == jeng.output_tokens
    assert teng.pool.free_blocks == jeng.pool.free_blocks


def test_small_pool_preempts_and_finishes(weights):
    # 4 prompts of 2 blocks fill 8 of 10 blocks; growing past 32 tokens
    # needs a third block each, so decode preempts (LIFO, recompute).
    specs = [(30, 20)] * 4 + [(10, 4)] * 2
    jeng, teng = _run_both(weights, "fcfs", specs, kv_pool_tokens=160)
    assert jeng.preemptions > 0 and teng.preemptions == jeng.preemptions
    assert teng.output_tokens == jeng.output_tokens
    assert teng.pool.allocs == {} and teng.pool.free_blocks == teng.pool.total_blocks


def test_engine_defaults_to_gpu_and_raises_without_one(weights):
    _, tcfg, _, tp = weights
    with pytest.raises(RuntimeError):
        ServingEngine(tcfg, tp, tcore.FCFSScheduler(), EngineConfig(**ECFG))


@pytest.mark.parametrize("extra", [dict(chunk_prefill_tokens=16),
                                   dict(enable_prefix_cache=True)],
                         ids=["chunked", "radix"])
def test_unported_engine_features_raise(ssm_weights, extra):
    """Chunked prefill and radix reuse run on the dense families; the SSM
    family cannot chunk (``supports_chunked_decode``), and both engines
    refuse either mode with ValueError rather than fall back."""
    jcfg, tcfg, jp, tp = ssm_weights
    with pytest.raises(ValueError):
        ServingEngine(tcfg, tp, tcore.FCFSScheduler(),
                      EngineConfig(**ECFG, **extra), device="cpu")
    with pytest.raises(ValueError):
        JaxEngine(jcfg, jp, jcore.FCFSScheduler(),
                  JaxEngineConfig(**ECFG, **extra))


def test_caches_hold_what_the_jax_engine_holds(fcfs_pair):
    """In-place slot writes leave the same KV as the JAX engine's
    functional updates (rows of finished sequences included)."""
    jeng, teng = fcfs_pair
    tcfg = get_smoke_config(ARCH)
    got = bridge.caches_to_numpy(teng.caches, tcfg)
    for a, b in zip(jax.tree.leaves(jeng.caches), jax.tree.leaves(got)):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-4, rtol=1e-4)
    assert isinstance(teng.caches[0]["k"], torch.Tensor)


# ---- the SSM family (mamba2 smoke config) -----------------------------------

SSM_ARCH = "mamba2-370m"


@pytest.fixture(scope="module")
def ssm_weights():
    """(JAX config, port config, JAX params, port params) of mamba2."""
    jcfg, tcfg = jax_smoke(SSM_ARCH), get_smoke_config(SSM_ARCH)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    return jcfg, tcfg, jp, tp


def _ssm_specs(n: int, seed: int, lengths):
    rng = np.random.default_rng(seed)
    return [(int(rng.choice(lengths)), int(rng.integers(2, 7)))
            for _ in range(n)]


@pytest.mark.parametrize("name", ["fcfs", "ewsjf"])
def test_ssm_one_prompt_length_matches_jax_engine(ssm_weights, name):
    """With one prompt length no row is padded, where the JAX engine is
    right: greedy tokens, dispatch order and pool counts agree."""
    jeng, teng = _run_both(ssm_weights, name, [(24, n) for n in
                                               (3, 6, 2, 5, 4, 6, 2, 3, 5, 4)],
                           explicit_tokens=True)
    assert not teng.e.pad_prompts and not jeng.e.pad_prompts
    assert teng.output_tokens == jeng.output_tokens
    assert [rid for _, rid in teng.dispatch_log] == \
        [rid for _, rid in jeng.dispatch_log]
    for attr in ("total_blocks", "block_size", "free_blocks", "allocs"):
        assert getattr(teng.pool, attr) == getattr(jeng.pool, attr)
    assert isinstance(teng.caches[0]["ssm"], torch.Tensor)


@pytest.mark.parametrize("name", ["fcfs", "ewsjf"])
def test_ssm_mixed_lengths_match_one_request_at_a_time(ssm_weights, name):
    """Mixed prompt lengths (at most one chunk, or whole chunks, so the JAX
    prefill runs): the port's batched engine gives every request the greedy
    tokens of a JAX engine that prefills one request at a time."""
    jcfg, tcfg, jp, tp = ssm_weights
    specs = _ssm_specs(12, seed=3, lengths=(5, 9, 17, 24, 32, 64, 96))
    teng = ServingEngine(tcfg, tp, _scheduler(tcore, name),
                         EngineConfig(**ECFG), device="cpu")
    jeng = JaxEngine(jcfg, jp, _scheduler(jcore, name),
                     JaxEngineConfig(**{**ECFG, "max_slots": 1}))
    tfin = teng.run(_requests(tcore, specs, jcfg.vocab_size, True),
                    max_steps=4000)
    jfin = jeng.run(_requests(jcore, specs, jcfg.vocab_size, True),
                    max_steps=4000)
    assert len(tfin) == len(jfin) == len(specs)
    assert teng.prefill_batches < len(specs)      # rows really were batched
    assert teng.output_tokens == jeng.output_tokens
    assert teng.pool.free_blocks == teng.pool.total_blocks == \
        jeng.pool.free_blocks
