"""internvl2-76b, the embedding-input family, in the PyTorch port on the CPU,
against the JAX package.

internvl2 is a GQA decoder (hd 128, H 64 / K 8 at full width) whose prefill
takes embeddings (the vision frontend is a stub in the JAX package too)
and whose decode takes text tokens.  Its smoke config has 4 layers, d 64, 4
heads of 16 on 2 KV heads.  The engines serve it as the JAX engine does:
prompt tokens go through the embedding table, then into the prefill as
``{"embeddings"}``.  Weights come from the JAX initializer and cross
through ``bridge``.  On CPU tensors the port runs the plain versions of its
kernels.  Everything runs in f32: logits agree at 2e-5 relative to their
scale, caches too, greedy tokens exactly.
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
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.launch.serve import (CARD_DEPTH_CUTS, CARD_ENGINE_CONFIGS,
                                      card_config, depth_label)
from repro_torch.models import (DtypePolicy, decode_step, init_decode_caches,
                                init_params, prefill, supports_chunked_decode)
from repro_torch.serving import EngineConfig, ServingEngine

ARCH = "internvl2-76b"
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


def test_config_is_the_published_one_and_its_card_cut():
    """The port's copy registers the published config and its smoke
    variant; the card serve takes 24 of its 80 layers at published widths
    (70.55 B parameters, ~141 GB in bf16, cut to ~22.6 B, ~45.3 GB)."""
    assert ARCH in list_archs()
    for got, want in ((get_config(ARCH), jax_config(ARCH)),
                      (get_smoke_config(ARCH), jax_smoke(ARCH))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff) == (80, 8192, 64, 8, 128, 28672)
    assert cfg.input_mode == "embeddings" and not cfg.is_encoder_only
    assert not supports_chunked_decode(cfg)
    assert round(cfg.param_count() / 1e9, 2) == 70.55
    cut = card_config(ARCH)
    assert CARD_DEPTH_CUTS[ARCH] == cut.n_layers == 24
    assert dataclasses.replace(cut, n_layers=80) == cfg
    assert round(cut.param_count() / 1e9, 1) == 22.6
    assert depth_label(cut) == "24 of 80 layers (cut)"
    assert ARCH in CARD_ENGINE_CONFIGS and "qwen3-4b" in CARD_ENGINE_CONFIGS
    assert card_config("qwen3-4b") == get_config("qwen3-4b")


def test_bridge_params_round_trip_exact(weights):
    """An embedding table (decode takes tokens) and an untied head; the
    tree crosses back exactly, and ``init_params`` makes the same
    shapes."""
    jcfg, tcfg, jp, tp = weights
    assert "embed" in jp and "head" in jp
    back = bridge.params_to_numpy(tp, tcfg)
    assert jax.tree.structure(jp) == jax.tree.structure(back)
    assert all(np.array_equal(np.asarray(x), y) for x, y in
               zip(jax.tree.leaves(jp), jax.tree.leaves(back)))
    init = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(p.shape) for p in init.parameters()] == \
        [tuple(p.shape) for p in tp.parameters()]


def test_prefill_embeddings_match_jax(weights):
    """``prefill({"embeddings"})`` on patch embeddings drawn with numpy:
    last-position logits and K/V caches against JAX's."""
    jcfg, tcfg, jp, tp = weights
    x = np.random.default_rng(3).standard_normal((2, 20, jcfg.d_model)) \
        .astype(np.float32)
    jl, jc = jax_prefill(jp, {"embeddings": jnp.asarray(x)}, jcfg, policy=J32)
    tl, tc = prefill(tp, {"embeddings": torch.from_numpy(x)}, tcfg,
                     policy=T32)
    assert tuple(tl.shape) == (2, 1, jcfg.vocab_size)
    assert _rel(tl, jl) <= REL
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(
            bridge.caches_to_numpy(tc, tcfg))):
        assert _rel(b, a) <= REL


def test_prefill_and_eight_decode_steps_match_jax(weights):
    """One prefill of 3 rows of embeddings (the engine's: the prompt
    tokens' table rows), then 8 greedy token decode steps with rows at
    different positions: logits at 2e-5 relative, caches too, greedy
    tokens equal."""
    jcfg, tcfg, jp, tp = weights
    rng = np.random.default_rng(4)
    S, s_max = 24, 48
    toks = rng.integers(0, jcfg.vocab_size, (3, S)).astype(np.int32)
    emb = np.asarray(jp["embed"])[toks]
    jl, jc = jax_prefill(jp, {"embeddings": jnp.asarray(emb)}, jcfg,
                         policy=J32)
    tl, tc = prefill(tp, {"embeddings": torch.from_numpy(emb)}, tcfg,
                     policy=T32)
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


# ---- the engine ----------------------------------------------------------

ECFG = dict(max_slots=4, s_max=256, kv_pool_tokens=16384,
            buckets=(32, 64, 128, 256))


def _requests(pkg, n=8, seed=0):
    """8-99-token prompts with their tokens, 6 new tokens each."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(seed * 1000 + i)
        pl = int(rng.integers(8, 100))
        toks = rng.integers(0, 256, size=(pl,)).astype(np.int32)
        out.append(pkg.Request(request_id=i, arrival_time=0.0, prompt_len=pl,
                               max_new_tokens=6, prompt_tokens=toks))
    return out


def _ewsjf(pkg):
    # re-optimisation needs 100 finished requests, so the queue layout stays
    # the initial one in both engines
    return pkg.EWSJFScheduler(pkg.EWSJFConfig(min_history=100,
                                              reopt_interval=1e9))


def test_engine_serve_matches_jax(weights):
    """A bucketed EWSJF serve of 8 requests: greedy tokens, dispatch
    order, pool accounting and batch stats equal the JAX engine's, and
    the slot caches hold its K/V rows."""
    jcfg, tcfg, jp, tp = weights
    jeng = JaxEngine(jcfg, jp, _ewsjf(jcore), JaxEngineConfig(**ECFG))
    jeng.run(_requests(jcore), max_steps=4000)
    teng = ServingEngine(tcfg, tp, _ewsjf(tcore), EngineConfig(**ECFG),
                         device="cpu")
    teng.run(_requests(tcore), max_steps=4000)
    assert len(teng.finished) == len(jeng.finished) == 8
    assert teng.output_tokens == jeng.output_tokens
    assert all(len(v) == 6 for v in teng.output_tokens.values())
    assert [rid for _, rid in teng.dispatch_log] == \
        [rid for _, rid in jeng.dispatch_log]
    assert teng.pool.free_blocks == jeng.pool.free_blocks
    js, ts = jeng.stats(), teng.stats()
    for key in ("preemptions", "prefill_batches", "padding_waste"):
        assert ts[key] == js[key], key
    got = bridge.caches_to_numpy(teng.caches, tcfg)
    for a, b in zip(jax.tree.leaves(jeng.caches), jax.tree.leaves(got)):
        np.testing.assert_allclose(b, np.asarray(a), atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("mode", [dict(chunk_prefill_tokens=32),
                                  dict(enable_prefix_cache=True)])
def test_chunked_and_prefix_modes_refused(weights, mode):
    """A chunk is tokens, so neither engine runs chunked prefill or prefix
    reuse for a model fed embeddings: both raise ``ValueError``."""
    jcfg, tcfg, jp, tp = weights
    with pytest.raises(ValueError):
        JaxEngine(jcfg, jp, jcore.FCFSScheduler(),
                  JaxEngineConfig(**ECFG, **mode))
    with pytest.raises(ValueError):
        ServingEngine(tcfg, tp, tcore.FCFSScheduler(),
                      EngineConfig(**ECFG, **mode), device="cpu")
