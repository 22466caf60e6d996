"""The PyTorch port's MLA attention and the deepseek-v2-lite model on the
CPU, against the JAX package.

deepseek-v2-lite's smoke config: 3 layers (the first with a dense MLP, the
others MoE with 8 experts, top-2, one shared), d 64, 4 heads, head dim 16
+ 8 rope, latent rank 32.  Weights come from the JAX initializer and cross
through ``bridge``; the JAX ``{"latent", "k_rope"}`` cache pair crosses
into the port's one ``{"ckv"}`` tensor and back.  On CPU tensors the port
runs the plain versions of its kernels: MLA prefill through flash
attention with keys of hd + rd and values of vd, absorbed decode through
paged attention over the latent rows.  Everything runs in f32; outputs
must agree at 2e-5 relative to their scale (CPU matmuls sum in different
orders), and greedy tokens exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.configs import get_smoke_config as jax_smoke
from repro.models import DtypePolicy as JaxPolicy
from repro.models import decode_step as jax_decode
from repro.models import init_params as jax_init
from repro.models import prefill as jax_prefill
from repro.models.attention import mla_decode as jax_mla_decode
from repro.models.attention import mla_forward as jax_mla_forward
from repro.models.model import pad_prefill_caches
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.models import (DtypePolicy, chunk_step, decode_step,
                                init_decode_caches, prefill)
from repro_torch.models.attention import mla_decode, mla_forward
from repro_torch.serving import EngineConfig, ServingEngine

ARCH = "deepseek-v2-lite-16b"
REL = 2e-5
J32 = JaxPolicy(jnp.float32, jnp.float32, jnp.float32)
T32 = DtypePolicy(torch.float32, torch.float32, torch.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def weights():
    """(JAX config, port config, JAX params, port params)."""
    jcfg, tcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    return jcfg, tcfg, jp, tp


def _mixer(jp, layer: int):
    """The JAX mixer params of layer ``layer`` (1 and 2 sit in the stacked
    periods, axis 0)."""
    if layer == 0:
        return jp["blocks"]["head"][0]["mixer"]
    return jax.tree.map(lambda a: a[layer - 1],
                        jp["blocks"]["stack"]["slot_0"]["mixer"])


def _leaves_equal(a, b) -> bool:
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return (jax.tree.structure(a) == jax.tree.structure(b)
            and all(np.array_equal(np.asarray(x), y) for x, y in zip(la, lb)))


def test_bridge_params_round_trip_exact(weights):
    jcfg, tcfg, jp, tp = weights
    assert [b.use_moe for b in tp.blocks] == [False, True, True]
    assert tp.blocks[1].mlp["router"].dtype == torch.float32
    assert tp.blocks[1].shared is not None and tp.blocks[0].shared is None
    assert _leaves_equal(jp, bridge.params_to_numpy(tp, tcfg))


def test_bridge_cache_round_trip_exact(weights):
    jcfg, tcfg, jp, _ = weights
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 12))
    _, caches = jax_prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                            jcfg, policy=J32)
    tc = bridge.caches_from_jax(jax.tree.map(np.asarray, caches), tcfg,
                                device="cpu")
    r, rd = jcfg.kv_lora_rank, jcfg.rope_head_dim
    assert [tuple(c["ckv"].shape) for c in tc] == [(2, 12, 1, r + rd)] * 3
    assert _leaves_equal(caches, bridge.caches_to_numpy(tc, tcfg))


@pytest.mark.parametrize("layer", [0, 2])
def test_mla_forward_matches_jax(weights, layer):
    jcfg, tcfg, jp, tp = weights
    rng = np.random.default_rng(layer)
    B, S = 2, 40
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jy, jkv = jax_mla_forward(_mixer(jp, layer), jnp.asarray(x), jcfg,
                              positions=jnp.asarray(pos), return_kv=True)
    ty, tkv = mla_forward(tp.blocks[layer].mixer, torch.from_numpy(x), tcfg,
                          positions=torch.from_numpy(pos.copy()),
                          return_kv=True)
    assert _rel(ty, jy) <= REL
    r = jcfg.kv_lora_rank
    ckv = tkv["ckv"][:, :, 0].numpy()
    assert _rel(ckv[..., :r], jkv["latent"]) <= REL
    assert _rel(ckv[..., r:], jkv["k_rope"]) <= REL


def test_mla_decode_matches_jax_with_bridged_caches(weights):
    """Absorbed decode over a random latent cache: four steps with rows at
    different positions, the cache bridged into the port once and back out
    after every step."""
    jcfg, tcfg, jp, tp = weights
    rng = np.random.default_rng(3)
    B, s_max = 3, 48
    r, rd = jcfg.kv_lora_rank, jcfg.rope_head_dim
    jc = {"latent": jnp.asarray(rng.standard_normal((B, s_max, r)),
                                jnp.float32),
          "k_rope": jnp.asarray(rng.standard_normal((B, s_max, rd)),
                                jnp.float32)}
    tc = bridge.caches_from_jax({"head": [jax.tree.map(np.asarray, jc)],
                                 "tail": []}, tcfg.scaled(n_layers=1),
                                device="cpu")[0]
    pos = np.array([40, 17, 0], dtype=np.int32)
    for _ in range(4):
        x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
        jy, jc = jax_mla_decode(_mixer(jp, 1), jnp.asarray(x), jc,
                                jnp.asarray(pos), jcfg)
        ty, tc = mla_decode(tp.blocks[1].mixer, torch.from_numpy(x), tc,
                            pos, tcfg)
        assert _rel(ty, jy) <= REL
        back = bridge.caches_to_numpy([tc], tcfg.scaled(n_layers=1))["head"][0]
        for name in ("latent", "k_rope"):
            assert _rel(back[name], jc[name]) <= REL
        pos = pos + 1


def test_prefill_and_eight_decode_steps_match_jax(weights):
    """Whole model, f32: one prefill, then 8 greedy decode steps with rows
    at different positions; logits at 2e-5 relative, greedy tokens
    equal."""
    jcfg, tcfg, jp, tp = weights
    rng = np.random.default_rng(4)
    S, s_max = 24, 48
    toks = rng.integers(0, jcfg.vocab_size, (3, S)).astype(np.int32)
    jl, jc = jax_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, policy=J32)
    tl, tc = prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, policy=T32)
    assert _rel(tl, jl) <= REL
    jc = pad_prefill_caches(jc, jcfg, s_max)
    tcache = init_decode_caches(tcfg, 3, s_max, dtype=torch.float32,
                                device="cpu")
    for dst, src in zip(tcache, tc):
        dst["ckv"][:, :S].copy_(src["ckv"])
    pos = np.array([S, 17, 5], dtype=np.int32)      # rows at different lengths
    jtok = np.asarray(jnp.argmax(jl[:, 0], -1))[:, None].astype(np.int32)
    ttok = tl[:, 0].argmax(-1, keepdim=True).to(torch.int32)
    assert np.array_equal(jtok, ttok.numpy())
    for _ in range(8):
        jl, jc = jax_decode(jp, jnp.asarray(jtok), jc, jnp.asarray(pos), jcfg,
                            policy=J32)
        tl, tcache = decode_step(tp, ttok, tcache, pos, tcfg, policy=T32)
        assert tl.shape == (3, 1, jcfg.vocab_size)
        assert _rel(tl, jl) <= REL
        for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(
                bridge.caches_to_numpy(tcache, tcfg))):
            assert _rel(b, a) <= REL
        jtok = np.asarray(jnp.argmax(jl[:, 0], -1))[:, None].astype(np.int32)
        ttok = tl[:, 0].argmax(-1, keepdim=True).to(torch.int32)
        assert np.array_equal(jtok, ttok.numpy())
        pos = pos + 1


# ---- the engine ----------------------------------------------------------

ECFG = dict(max_slots=4, s_max=128, kv_pool_tokens=2048,
            buckets=(32, 64, 128))


def _requests(pkg, vocab: int):
    """8 mixed requests at t=0: 6 short prompts (6-29 tokens), 2 long
    (60-109), 2-6 new tokens each, explicit prompt tokens."""
    rng = np.random.default_rng(7)
    reqs = []
    for i in range(8):
        ln = int(rng.integers(60, 110) if i in (2, 5) else rng.integers(6, 30))
        r = pkg.Request(prompt_len=ln, arrival_time=0.0,
                        max_new_tokens=int(rng.integers(2, 7)),
                        request_id=70_000 + i)
        r.prompt_tokens = rng.integers(0, vocab, ln).astype(np.int32)
        reqs.append(r)
    return reqs


def _ewsjf(pkg):
    # re-optimisation needs 100 finished requests, so the queue layout stays
    # the initial one in both engines
    return pkg.EWSJFScheduler(pkg.EWSJFConfig(min_history=100,
                                              reopt_interval=1e9))


def test_ewsjf_engine_tokens_match_jax_engine(weights):
    """EWSJF bucketed serve of 8 mixed requests, MoE in ``dropping`` mode:
    every request's greedy tokens equal the JAX engine's.  A prefill
    batch's drops depend on its rows, so both engines must also have
    dispatched in the same order and batches."""
    jcfg, tcfg, jp, tp = weights
    jeng = JaxEngine(jcfg, jp, _ewsjf(jcore), JaxEngineConfig(**ECFG))
    teng = ServingEngine(tcfg, tp, _ewsjf(tcore), EngineConfig(**ECFG),
                         device="cpu")
    jfin = jeng.run(_requests(jcore, jcfg.vocab_size), max_steps=4000)
    tfin = teng.run(_requests(tcore, jcfg.vocab_size), max_steps=4000)
    assert len(jfin) == len(tfin) == 8
    assert teng.e.moe_impl == jeng.e.moe_impl == "dropping"
    assert [rid for _, rid in teng.dispatch_log] == \
        [rid for _, rid in jeng.dispatch_log]
    assert teng.prefill_batches == jeng.prefill_batches
    assert teng.output_tokens == jeng.output_tokens
    assert all(len(v) > 1 for v in teng.output_tokens.values())
    assert teng.pool.free_blocks == teng.pool.total_blocks
    got = bridge.caches_to_numpy(teng.caches, tcfg)
    for a, b in zip(jax.tree.leaves(jeng.caches), jax.tree.leaves(got)):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("extra", [dict(chunk_prefill_tokens=16),
                                   dict(enable_prefix_cache=True)],
                         ids=["chunked", "radix"])
def test_chunked_and_prefix_modes_raise_for_mla(weights, extra):
    """MLA chunked prefill and radix reuse come with the next slice: the
    engine refuses either mode rather than fall back, and so does
    ``chunk_step``."""
    _, tcfg, _, tp = weights
    with pytest.raises(NotImplementedError, match="next slice"):
        ServingEngine(tcfg, tp, tcore.FCFSScheduler(),
                      EngineConfig(**ECFG, **extra), device="cpu")
    caches = init_decode_caches(tcfg, 1, 32, dtype=torch.float32,
                                device="cpu")
    with pytest.raises(NotImplementedError, match="next slice"):
        chunk_step(tp, torch.zeros((1, 4), dtype=torch.int32), caches, 0,
                   tcfg, policy=T32)
