"""The PyTorch port's model path on the CPU, against the JAX package.

Weights come from the JAX initializer and cross through ``bridge`` (numpy on
both sides).  Prefill logits and caches, and decode steps with per-row cache
positions, must match the JAX functions in f32 at ``atol=rtol=1e-4``: CPU
matmuls in the two frameworks sum in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import DtypePolicy as JaxPolicy
from repro.models import decode_step as jax_decode
from repro.models import init_params as jax_init
from repro.models import prefill as jax_prefill
from repro.models.model import pad_prefill_caches
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import DtypePolicy, decode_step, init_params, prefill

ARCHS = ["llama2-13b", "qwen3-4b"]      # qwen3: GQA and qk_norm
TOL = 1e-4
J32 = JaxPolicy(jnp.float32, jnp.float32, jnp.float32)
T32 = DtypePolicy(torch.float32, torch.float32, torch.float32)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, JAX config, port config, JAX params, port params)."""
    arch = request.param
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    return arch, jcfg, tcfg, jp, tp


def _leaves_equal(a, b) -> bool:
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return (jax.tree.structure(a) == jax.tree.structure(b)
            and all(np.array_equal(np.asarray(x), y) for x, y in zip(la, lb)))


def test_bridge_params_round_trip_exact(pair):
    _, jcfg, tcfg, jp, tp = pair
    assert len(tp.blocks) == jcfg.n_layers
    assert _leaves_equal(jp, bridge.params_to_numpy(tp, tcfg))


def test_bridge_cache_round_trip_exact(pair):
    _, jcfg, tcfg, jp, _ = pair
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    _, caches = jax_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                            policy=J32)
    tc = bridge.caches_from_jax(jax.tree.map(np.asarray, caches), tcfg,
                                device="cpu")
    assert len(tc) == jcfg.n_layers
    assert _leaves_equal(caches, bridge.caches_to_numpy(tc, tcfg))


def test_prefill_matches_jax(pair):
    _, jcfg, tcfg, jp, tp = pair
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    jl, jc = jax_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, policy=J32)
    tl, tc = prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, policy=T32)
    assert tl.shape == (2, 1, jcfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    for a, b in zip(jax.tree.leaves(jc),
                    jax.tree.leaves(bridge.caches_to_numpy(tc, tcfg))):
        np.testing.assert_allclose(b, np.asarray(a), atol=TOL, rtol=TOL)


def test_decode_steps_match_jax_per_row_positions(pair):
    _, jcfg, tcfg, jp, tp = pair
    rng = np.random.default_rng(2)
    S, s_max = 24, 48
    toks = rng.integers(0, jcfg.vocab_size, (3, S)).astype(np.int32)
    _, jc = jax_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, policy=J32)
    jc = pad_prefill_caches(jc, jcfg, s_max)
    tc = bridge.caches_from_jax(jax.tree.map(np.asarray, jc), tcfg,
                                device="cpu")
    pos = np.array([S, 17, 5], dtype=np.int32)      # rows at different lengths
    tok = rng.integers(0, jcfg.vocab_size, (3, 1)).astype(np.int32)
    for _ in range(4):
        jl, jc = jax_decode(jp, jnp.asarray(tok), jc, jnp.asarray(pos), jcfg,
                            policy=J32)
        tl, tc = decode_step(tp, torch.from_numpy(tok), tc, pos, tcfg,
                             policy=T32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        for a, b in zip(jax.tree.leaves(jc),
                        jax.tree.leaves(bridge.caches_to_numpy(tc, tcfg))):
            np.testing.assert_allclose(b, np.asarray(a), atol=TOL, rtol=TOL)
        tok = np.asarray(jnp.argmax(jl[:, 0], axis=-1))[:, None].astype(np.int32)
        assert np.array_equal(tok, tl[:, 0].argmax(-1, keepdim=True).numpy())
        pos = pos + 1


def test_decode_rejects_positions_past_the_cache(pair):
    _, jcfg, tcfg, _, tp = pair
    caches = [{"k": torch.zeros((1, 8, jcfg.n_kv_heads, jcfg.head_dim)),
               "v": torch.zeros((1, 8, jcfg.n_kv_heads, jcfg.head_dim))}
              for _ in range(jcfg.n_layers)]
    with pytest.raises(ValueError):
        decode_step(tp, torch.zeros((1, 1), dtype=torch.int32), caches,
                    np.array([8]), tcfg, policy=T32)


def test_init_params_seeded_and_gpu_by_default():
    cfg = get_smoke_config("llama2-13b")
    a = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not any(p.requires_grad for p in a.parameters())
    with pytest.raises(RuntimeError):
        init_params(cfg, torch.Generator())       # device defaults to cuda


@pytest.mark.parametrize("overrides", [
    dict(pattern=("attn", "conv")),       # a layer kind JAX lacks too
])
def test_unported_families_raise(overrides):
    """Every family of the JAX package builds (encoder-only and
    embedding-input ones since they were ported); a layer kind the JAX
    package does not have either still raises."""
    cfg = ModelConfig(name="x", family=overrides.pop("family", "dense"),
                      n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                      d_ff=64, vocab_size=64, **overrides)
    with pytest.raises(NotImplementedError, match="conv"):
        init_params(cfg, torch.Generator(), device="cpu")
