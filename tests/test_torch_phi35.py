"""phi3.5-moe-42b-a6.6b in the PyTorch port on the CPU, against the JAX
package.

phi3.5-moe is GQA attention (hd 128, G = 4 at full width) with an MoE MLP in
every layer: 16 experts, top-2, no shared experts.  Its smoke config has 4
layers, d 64, 4 heads of 16 on 2 KV heads, 4 experts top-2.  Weights come
from the JAX initializer and cross through ``bridge``.  On CPU tensors the
port runs the plain versions of its kernels.  Everything runs in f32:
logits agree at 2e-5 relative to their scale, caches within the chunked
tests' 5e-5, greedy tokens exactly.  Under ``dropping`` both packages rank
capacity over the whole padded batch (``ROADMAP.md`` §3), so every
comparison hands both the same batches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import DtypePolicy as JaxPolicy
from repro.models import decode_step as jax_decode
from repro.models import init_params as jax_init
from repro.models import prefill as jax_prefill
from repro.models.model import pad_prefill_caches
from repro.models.transformer import MoECtx
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.launch.serve import CARD_DEPTH_CUTS, card_config
from repro_torch.models import (DtypePolicy, decode_step, init_decode_caches,
                                prefill, supports_chunked_decode)
from repro_torch.serving import EngineConfig, ServingEngine

ARCH = "phi3.5-moe-42b-a6.6b"
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


def test_config_is_the_published_one_and_its_card_cut():
    """The port's copy registers the published config and its smoke
    variant; the card serve takes 16 of its 32 layers at published widths
    (about 21.1 B of 41.87 B parameters, 42 GB in bf16)."""
    assert ARCH in list_archs()
    for got, want in ((get_config(ARCH), jax_config(ARCH)),
                      (get_smoke_config(ARCH), jax_smoke(ARCH))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.head_dim,
            cfg.n_heads // cfg.n_kv_heads) == (32, 4096, 128, 4)
    assert (cfg.n_experts, cfg.moe_top_k, cfg.n_shared_experts) == (16, 2, 0)
    assert supports_chunked_decode(cfg)
    assert round(cfg.param_count() / 1e9, 2) == 41.87
    cut = card_config(ARCH)
    assert CARD_DEPTH_CUTS[ARCH] == cut.n_layers == 16
    assert dataclasses.replace(cut, n_layers=32) == cfg
    assert 21.0e9 < cut.param_count() < 21.2e9
    assert card_config("llama2-13b") == get_config("llama2-13b")


def test_bridge_params_round_trip_exact(weights):
    """Every layer carries an MoE MLP without shared experts; the tree
    crosses back exactly."""
    jcfg, tcfg, jp, tp = weights
    assert all(b.use_moe and b.shared is None for b in tp.blocks)
    back = bridge.params_to_numpy(tp, tcfg)
    assert jax.tree.structure(jp) == jax.tree.structure(back)
    assert all(np.array_equal(np.asarray(x), y) for x, y in
               zip(jax.tree.leaves(jp), jax.tree.leaves(back)))


@pytest.mark.parametrize("moe_impl", ["dense", "dropping"])
def test_prefill_and_eight_decode_steps_match_jax(weights, moe_impl):
    """One prefill of 3 rows, then 8 greedy decode steps with rows at
    different positions, each MoE layer by ``moe_impl`` in both packages:
    logits at 2e-5 relative, caches too, greedy tokens equal."""
    jcfg, tcfg, jp, tp = weights
    ctx = MoECtx(impl=moe_impl)
    rng = np.random.default_rng(4)
    S, s_max = 24, 48
    toks = rng.integers(0, jcfg.vocab_size, (3, S)).astype(np.int32)
    jl, jc = jax_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, ctx,
                         policy=J32)
    tl, tc = prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                     policy=T32, moe_impl=moe_impl)
    assert _rel(tl, jl) <= REL
    jc = pad_prefill_caches(jc, jcfg, s_max)
    tcache = init_decode_caches(tcfg, 3, s_max, dtype=torch.float32,
                                device="cpu")
    for dst, src in zip(tcache, tc):
        for name, t in src.items():
            dst[name][:, :S].copy_(t)
    pos = np.array([S, 17, 5], dtype=np.int32)
    jtok = np.asarray(jnp.argmax(jl[:, 0], -1))[:, None].astype(np.int32)
    ttok = tl[:, 0].argmax(-1, keepdim=True).to(torch.int32)
    assert np.array_equal(jtok, ttok.numpy())
    for _ in range(8):
        jl, jc = jax_decode(jp, jnp.asarray(jtok), jc, jnp.asarray(pos), jcfg,
                            ctx, policy=J32)
        tl, tcache = decode_step(tp, ttok, tcache, pos, tcfg, policy=T32,
                                 moe_impl=moe_impl)
        assert _rel(tl, jl) <= REL
        for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(
                bridge.caches_to_numpy(tcache, tcfg))):
            assert _rel(b, a) <= REL
        jtok = np.asarray(jnp.argmax(jl[:, 0], -1))[:, None].astype(np.int32)
        ttok = tl[:, 0].argmax(-1, keepdim=True).to(torch.int32)
        assert np.array_equal(jtok, ttok.numpy())
        pos = pos + 1


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
    """The JAX and the port engine under EWSJF (MoE ``dropping``, both
    engines' default) over two waves of 6 requests sharing a 48-token
    prefix, in one mode."""
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
    """The slot caches after the run hold the JAX engine's K/V rows, within
    the chunked tests' f32 tolerance."""
    _, jeng, teng = engines
    got = bridge.caches_to_numpy(teng.caches, teng.cfg)
    for a, b in zip(jax.tree.leaves(jeng.caches), jax.tree.leaves(got)):
        np.testing.assert_allclose(b, np.asarray(a), atol=ATOL, rtol=ATOL)
