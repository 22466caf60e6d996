"""The PyTorch port's MoE layer on the CPU, against the JAX package.

deepseek-v2-lite's smoke config (8 experts, top-2, one shared expert).
Router and expert weights come from the JAX initializer and cross through
numpy; inputs are numpy draws from a seed.  The router (f32 softmax, top-k,
renormalised gates), the capacity, the dense path and the capacity-dropping
path must match the JAX functions in f32 at 1e-5 relative to the output's
scale: CPU matmuls in the two frameworks sum in different orders, and a
flipped top-k choice or a different dropped pair would move an output by a
whole expert, far past that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import init_params as jax_init
from repro.models.moe import _capacity as jax_capacity
from repro.models.moe import _route as jax_route
from repro.models.moe import init_moe as jax_init_moe
from repro.models.moe import moe_dense as jax_dense
from repro.models.moe import moe_dropping as jax_dropping
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxEngine
import repro.core as jcore
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.models import DtypePolicy, prefill
from repro_torch.models.moe import (_capacity, _route, init_moe, moe_dense,
                                    moe_dropping, moe_forward)

ARCH = "deepseek-v2-lite-16b"
REL = 1e-5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def layer():
    """(JAX config, port config, JAX MoE params, port MoE params)."""
    jcfg, tcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    jp = jax_init_moe(jax.random.PRNGKey(2), jcfg, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, tcfg, jp, tp


def _skewed(rng, B, S, d):
    """Tokens near one common direction, so the router sends most of them
    to the same experts and some (token, choice) pairs overflow."""
    base = rng.standard_normal((1, 1, d))
    return (base + 0.3 * rng.standard_normal((B, S, d))).astype(np.float32)


def _dropped(idx: np.ndarray, C: int) -> int:
    """(token, choice) pairs ranked at or past capacity C in their expert,
    in token-major order."""
    counts: dict = {}
    dropped = 0
    for e in idx.reshape(-1):
        counts[e] = counts.get(e, 0) + 1
        dropped += counts[e] > C
    return dropped


def test_route_matches_jax(layer):
    jcfg, tcfg, jp, tp = layer
    x = np.random.default_rng(0).standard_normal((40, jcfg.d_model)).astype(
        np.float32)
    jg, ji, jpr = jax_route(jnp.asarray(x), jp["router"], jcfg.moe_top_k)
    tg, ti, tpr = _route(torch.from_numpy(x), tp["router"], tcfg.moe_top_k)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert _rel(tg, jg) <= REL and _rel(tpr, jpr) <= REL
    np.testing.assert_allclose(tg.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("n", [1, 8, 16, 33, 128, 1000, 4096])
@pytest.mark.parametrize("arch", [ARCH])
def test_capacity_matches_jax(arch, n):
    for cf in (1.25, 2.0, 8.0):
        jcfg = jax_smoke(arch).scaled(capacity_factor=cf)
        tcfg = get_smoke_config(arch).scaled(capacity_factor=cf)
        assert _capacity(n, tcfg) == jax_capacity(n, jcfg)
    full = get_smoke_config(arch)
    assert _capacity(8, full) == 8           # decode at 8 slots never drops


@pytest.mark.parametrize("path", ["dense", "dropping"])
def test_moe_matches_jax_on_a_batch_that_drops(layer, path):
    """At the default capacity factor (1.25) the batch overflows some
    experts; the same pairs must drop in both packages, or the outputs
    would differ by a whole expert."""
    jcfg, tcfg, jp, tp = layer
    x = _skewed(np.random.default_rng(1), 2, 24, jcfg.d_model)
    jfn, tfn = {"dense": (jax_dense, moe_dense),
                "dropping": (jax_dropping, moe_dropping)}[path]
    jy, (_, jidx) = jfn(jp, jnp.asarray(x), jcfg)
    ty, (_, tidx) = tfn(tp, torch.from_numpy(x), tcfg)
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    C = _capacity(2 * 24, tcfg)
    assert _dropped(tidx.numpy(), C) > 0, "the batch must drop some pairs"
    assert ty.shape == x.shape
    assert _rel(ty, jy) <= REL
    if path == "dropping":
        dy, _ = moe_dense(tp, torch.from_numpy(x), tcfg)
        assert _rel(ty, dy) > 1e-3      # the drops really changed the output


def test_dense_equals_dropping_at_high_capacity(layer):
    """With capacity >= tokens nothing drops and the two paths agree
    (the twin of test_models_smoke.py::test_moe_dense_vs_dropping_high_capacity)."""
    _, tcfg, _, _ = layer
    cfg = tcfg.scaled(capacity_factor=8.0)
    gen = torch.Generator().manual_seed(0)
    mp = init_moe(gen, cfg, torch.float32, "cpu")
    x = torch.randn((2, 16, cfg.d_model), generator=gen)
    y1, _ = moe_dense(mp, x, cfg)
    y2, _ = moe_dropping(mp, x, cfg)
    torch.testing.assert_close(y1, y2, atol=1e-4, rtol=1e-4)


def test_init_moe_shapes_and_router_f32(layer):
    _, tcfg, _, tp = layer
    mp = init_moe(torch.Generator().manual_seed(0), tcfg, torch.bfloat16,
                  "cpu")
    assert mp["router"].dtype == torch.float32
    assert all(mp[k].dtype == torch.bfloat16 for k in ("w_gate", "w_up",
                                                       "w_down"))
    for k, v in mp.items():
        ref = tp[k]
        if k == "shared":
            assert {n: t.shape for n, t in v.items()} == \
                {n: t.shape for n, t in ref.items()}
        else:
            assert v.shape == ref.shape


def test_impls_dispatch_and_ep_a2a_raises(layer):
    _, tcfg, _, tp = layer
    x = torch.randn((1, 4, tcfg.d_model))
    for impl, fn in (("dense", moe_dense), ("dropping", moe_dropping)):
        torch.testing.assert_close(moe_forward(tp, x, tcfg, impl=impl)[0],
                                   fn(tp, x, tcfg)[0])
    # ep_a2a runs over a mesh (tests/test_torch_sharding.py); plain
    # tensors without one are refused
    with pytest.raises(ValueError, match="device mesh"):
        moe_forward(tp, x, tcfg, impl="ep_a2a")
    with pytest.raises(ValueError):
        moe_forward(tp, x, tcfg, impl="sparse")


# ---- a reference fault the port copies: padding routes and uses capacity ---

SHORT = 8      # one prompt of 8 tokens: alone, 8 tokens never overflow C = 8
PAD_TO = 64


@pytest.fixture(scope="module")
def model():
    """(JAX config, port config, JAX params, port params) of the whole
    smoke model."""
    jcfg, tcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    return jcfg, tcfg, jp, tp


def _first_logits(model, moe_impl: str, beside: bool):
    """The short prompt's first-token logits from a bucketed prefill, JAX
    engine and port: alone (one row of its own length) or as row 1 of a
    2-row batch right-padded to ``PAD_TO``, behind a 20-token prompt whose
    44 pad positions (token 0) route too, ahead of it in token-major
    order."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(0)
    short = rng.integers(1, jcfg.vocab_size, SHORT)
    if beside:
        first = rng.integers(1, jcfg.vocab_size, 20)
        toks = np.zeros((2, PAD_TO), np.int32)
        toks[0, :20], toks[1, :SHORT] = first, short
        lens, row = np.array([20, SHORT], np.int32), 1
    else:
        toks, lens, row = short[None].astype(np.int32), np.array([SHORT]), 0
    jeng = JaxEngine(jcfg, jp, jcore.FCFSScheduler(),
                     JaxEngineConfig(moe_impl=moe_impl))
    jl, _ = jeng._prefill_fn(jp, jnp.asarray(toks), jnp.asarray(lens))
    tl, _ = prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                    policy=DtypePolicy(torch.float32, torch.float32,
                                       torch.float32),
                    true_lens=torch.from_numpy(lens), moe_impl=moe_impl)
    return np.asarray(jl)[row, 0], tl[row, 0].numpy()


@pytest.mark.parametrize("moe_impl", ["dense", "dropping"])
def test_padding_beside_a_prompt_moves_its_logits_under_dropping(model,
                                                                 moe_impl):
    """Under ``dropping`` the short prompt's first-token logits depend on
    the batch it rides in: the prompt and pad positions of the row before
    it route too, fill the experts they share, and push some of its pairs
    past capacity.  Under ``dense`` nothing drops and the logits stay.  The port
    copies the JAX package here (parity first): both move alike."""
    j_alone, t_alone = _first_logits(model, moe_impl, beside=False)
    j_beside, t_beside = _first_logits(model, moe_impl, beside=True)
    assert _rel(t_alone, j_alone) <= 2e-5 and _rel(t_beside, j_beside) <= 2e-5
    moved = _rel(t_beside, t_alone)
    if moe_impl == "dense":
        assert moved <= 2e-5
    else:
        assert moved > 1e-3
        assert _rel(j_beside, j_alone) > 1e-3
