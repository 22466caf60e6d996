"""minicpm3-4b in the PyTorch port on the CPU, against the JAX package.

minicpm3-4b is MLA attention with dense SwiGLU MLPs (no MoE); its smoke
config has 4 layers, d 64, 4 heads of 16 + 8 rope, latent rank 32.
Weights come from the JAX initializer and cross through ``bridge``.  On
CPU tensors the port runs the plain versions of its kernels: prefill and
chunks through flash attention with keys of hd + rd and values of vd, a
chunk's keys and values decompressed from the latent rows; decode through
paged attention over the latent rows.  Everything runs in f32: outputs
agree at 2e-5 relative to their scale, caches within the chunked tests'
5e-5, greedy tokens exactly.  With no MoE the chunked path gives the
bucketed path's tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.configs import get_smoke_config as jax_smoke
from repro.models import DtypePolicy as JaxPolicy
from repro.models import chunk_step as jax_chunk_step
from repro.models import decode_step as jax_decode
from repro.models import init_decode_caches as jax_init_caches
from repro.models import init_params as jax_init
from repro.models import prefill as jax_prefill
from repro.models.model import pad_prefill_caches
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.models import (DtypePolicy, chunk_step, decode_step,
                                init_decode_caches, prefill,
                                supports_chunked_decode)
from repro_torch.serving import EngineConfig, ServingEngine

ARCH = "minicpm3-4b"
REL = 2e-5
ATOL = 5e-5
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


def test_config_is_the_published_one():
    """The port's copy registers the published widths and depth, and the
    (q/k, v) and (latent ‖ rope, latent) widths its kernels take."""
    from repro.configs import get_config as jax_config
    cfg = get_config(ARCH)
    assert ARCH in list_archs()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_config(ARCH))
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab_size) == \
        (62, 2560, 40, 73448)
    assert cfg.use_mla and cfg.n_experts == 0 and supports_chunked_decode(cfg)
    assert (cfg.head_dim + cfg.rope_head_dim, cfg.v_head_dim) == (96, 64)
    assert (cfg.kv_lora_rank + cfg.rope_head_dim, cfg.kv_lora_rank) == \
        (288, 256)


def test_bridge_params_round_trip_exact(weights):
    jcfg, tcfg, jp, tp = weights
    assert not any(b.use_moe for b in tp.blocks)
    back = bridge.params_to_numpy(tp, tcfg)
    la, lb = jax.tree.leaves(jp), jax.tree.leaves(back)
    assert jax.tree.structure(jp) == jax.tree.structure(back)
    assert all(np.array_equal(np.asarray(x), y) for x, y in zip(la, lb))


def test_prefill_and_eight_decode_steps_match_jax(weights):
    """One prefill of 3 rows, then 8 greedy decode steps with rows at
    different positions: logits at 2e-5 relative, caches too, greedy tokens
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
    pos = np.array([S, 17, 5], dtype=np.int32)
    jtok = np.asarray(jnp.argmax(jl[:, 0], -1))[:, None].astype(np.int32)
    ttok = tl[:, 0].argmax(-1, keepdim=True).to(torch.int32)
    assert np.array_equal(jtok, ttok.numpy())
    for _ in range(8):
        jl, jc = jax_decode(jp, jnp.asarray(jtok), jc, jnp.asarray(pos), jcfg,
                            policy=J32)
        tl, tcache = decode_step(tp, ttok, tcache, pos, tcfg, policy=T32)
        assert _rel(tl, jl) <= REL
        for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(
                bridge.caches_to_numpy(tcache, tcfg))):
            assert _rel(b, a) <= REL
        jtok = np.asarray(jnp.argmax(jl[:, 0], -1))[:, None].astype(np.int32)
        ttok = tl[:, 0].argmax(-1, keepdim=True).to(torch.int32)
        assert np.array_equal(jtok, ttok.numpy())
        pos = pos + 1


def test_chunk_step_matches_jax_and_one_prefill(weights):
    """Chunks of 16, 1, 16 and 8 through the port's chunk_step: each
    chunk's logits and the final caches equal JAX's chunk_step, and the
    last logits and the latent rows equal one prefill of all 41 tokens."""
    jcfg, tcfg, jp, tp = weights
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tcfg.vocab_size, size=(1, 41)).astype(np.int32)
    jc = jax_init_caches(jcfg, 1, 64, dtype=np.float32)
    tc = init_decode_caches(tcfg, 1, 64, dtype=torch.float32, device="cpu")
    pos = 0
    for width in (16, 1, 16, 8):
        chunk = toks[:, pos:pos + width]
        jl, jc = jax_chunk_step(jp, jnp.asarray(chunk), jc, np.int32(pos),
                                jcfg, policy=J32)
        tl, _ = chunk_step(tp, torch.from_numpy(chunk), tc, pos, tcfg,
                           policy=T32)
        assert _rel(tl, jl) <= REL
        pos += width
    for a, b in zip(jax.tree.leaves(jc),
                    jax.tree.leaves(bridge.caches_to_numpy(tc, tcfg))):
        np.testing.assert_allclose(b, np.asarray(a), atol=ATOL, rtol=ATOL)
    ref_logits, ref_caches = prefill(tp, {"tokens": torch.from_numpy(toks)},
                                     tcfg, policy=T32)
    np.testing.assert_allclose(tl.numpy(), ref_logits.numpy(), atol=ATOL)
    for layer, ref in zip(tc, ref_caches):
        np.testing.assert_allclose(layer["ckv"][:, :41].numpy(),
                                   ref["ckv"].numpy(), atol=ATOL)


# ---- the engine ----------------------------------------------------------

BASE = dict(max_slots=4, s_max=256, kv_pool_tokens=16384)
MODES = {"bucketed": dict(buckets=(32, 64, 128, 256)),
         "chunked+radix": dict(chunk_prefill_tokens=32,
                               enable_prefix_cache=True)}


def _requests(pkg, n=6, seed=0, base=0, prefix=None, vocab=256):
    """40-99-token prompts, the first up to 48 tokens of each the shared
    ``prefix``, 6 new tokens each (tests/test_torch_chunked.py's)."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(seed * 1000 + i)
        pl = int(rng.integers(40, 100))
        toks = rng.integers(0, vocab, size=(pl,)).astype(np.int32)
        if prefix is not None:
            toks[:min(len(prefix), pl - 8)] = prefix[:min(len(prefix), pl - 8)]
        out.append(pkg.Request(request_id=base + i, arrival_time=0.0,
                               prompt_len=pl, max_new_tokens=6,
                               prompt_tokens=toks))
    return out


def _two_waves(pkg):
    pfx = np.random.default_rng(7).integers(0, 256, size=(48,)).astype(
        np.int32)
    return (_requests(pkg, seed=3, prefix=pfx)
            + _requests(pkg, seed=6, prefix=pfx, base=10))


def _ewsjf(pkg):
    # re-optimisation needs 100 finished requests, so the queue layout stays
    # the initial one in both engines
    return pkg.EWSJFScheduler(pkg.EWSJFConfig(min_history=100,
                                              reopt_interval=1e9))


@pytest.fixture(scope="module", params=list(MODES))
def engines(request, weights):
    """The JAX and the port engine under EWSJF over two waves of 6
    requests sharing a 48-token prefix, in one mode."""
    jcfg, tcfg, jp, tp = weights
    ecfg = {**BASE, **MODES[request.param]}
    jeng = JaxEngine(jcfg, jp, _ewsjf(jcore), JaxEngineConfig(**ecfg))
    jeng.run(_two_waves(jcore), max_steps=4000)
    teng = ServingEngine(tcfg, tp, _ewsjf(tcore), EngineConfig(**ecfg),
                         device="cpu")
    teng.run(_two_waves(tcore), max_steps=4000)
    return request.param, jeng, teng


def test_engine_matches_jax(engines):
    """Bucketed and chunked+radix EWSJF serves: greedy tokens, dispatch
    order, pool accounting, cached_len per request, prefix-saved tokens,
    radix stats and chunk counts equal the JAX engine's."""
    mode, jeng, teng = engines
    assert len(teng.finished) == len(jeng.finished) == 12
    assert teng.output_tokens == jeng.output_tokens
    assert all(len(v) == 6 for v in teng.output_tokens.values())
    assert [rid for _, rid in teng.dispatch_log] == \
        [rid for _, rid in jeng.dispatch_log]
    assert teng.pool.free_blocks == jeng.pool.free_blocks
    assert {r.request_id: r.cached_len for r in teng.finished} == \
        {r.request_id: r.cached_len for r in jeng.finished}
    js, ts = jeng.stats(), teng.stats()
    for key in ("prefix_saved_tokens", "radix", "chunks", "chunk_tokens",
                "preemptions", "prefill_batches", "padding_waste"):
        assert ts.get(key) == js.get(key), key
    if mode == "chunked+radix":
        assert ts["prefix_saved_tokens"] > 0
        teng.radix.check_invariants()
    else:
        assert teng.pool.free_blocks == teng.pool.total_blocks


def test_engine_caches_match_jax(engines):
    """The slot caches after the run hold the JAX engine's latent and rope
    rows, within the chunked tests' f32 tolerance."""
    _, jeng, teng = engines
    got = bridge.caches_to_numpy(teng.caches, teng.cfg)
    for a, b in zip(jax.tree.leaves(jeng.caches), jax.tree.leaves(got)):
        np.testing.assert_allclose(b, np.asarray(a), atol=ATOL, rtol=ATOL)


def test_chunked_radix_tokens_equal_bucketed(weights):
    """With no MoE, chunked+radix prefill gives the bucketed path's greedy
    tokens for every request of both waves."""
    _, tcfg, _, tp = weights
    out = {}
    for mode, extra in MODES.items():
        eng = ServingEngine(tcfg, tp, tcore.FCFSScheduler(),
                            EngineConfig(**BASE, **extra), device="cpu")
        eng.run(_two_waves(tcore), max_steps=4000)
        out[mode] = eng.output_tokens
    assert len(out["bucketed"]) == 12
    assert out["bucketed"] == out["chunked+radix"]
