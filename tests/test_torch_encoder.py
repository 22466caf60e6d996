"""hubert-xlarge, the encoder-only family, in the PyTorch port on the CPU,
against the JAX package.

hubert is a bidirectional encoder fed frame embeddings (the modality
frontend is a stub in the JAX package too): no embedding table, GeLU MLPs
without a gate, per-position logits and no decode cache.  Its smoke config
has 4 layers, d 64, 4 heads of 16; the full one 48 layers, d 1280, 16
heads of 80 (hd 80, H = K), d_ff 5120, 504 targets.  Weights come from the
JAX initializer and cross through ``bridge``; frames are drawn with numpy
from a seed.  On CPU tensors the port runs the plain versions of its
kernels.  Everything runs in f32: logits agree at 2e-5 relative to their
scale (the JAX kernel tests' F32_TOL).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.core as jcore
import repro_torch.core as tcore
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.kernels.flash_attention.kernel import flash_attention_bhsd
from repro.models import DtypePolicy as JaxPolicy
from repro.models import init_params as jax_init
from repro.models import prefill as jax_prefill
from repro.models.mlp import init_mlp as jax_init_mlp
from repro.models.mlp import mlp_forward as jax_mlp_forward
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import (DtypePolicy, chunk_step, decode_step,
                                init_decode_caches, init_params, prefill,
                                supports_chunked_decode)
from repro_torch.models.mlp import init_mlp, mlp_forward
from repro_torch.serving import EngineConfig, ServingEngine

ARCH = "hubert-xlarge"
F32_TOL = 2e-5
J32 = JaxPolicy(jnp.float32, jnp.float32, jnp.float32)
T32 = DtypePolicy(torch.float32, torch.float32, torch.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _frames(cfg, B, S, seed):
    """Frame embeddings (B, S, d), N(0, 1), from numpy."""
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _pair(jcfg, tcfg, seed=0):
    jp = jax_init(jax.random.PRNGKey(seed), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def weights():
    """(JAX config, port config, JAX params, port params), smoke size."""
    jcfg, tcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    return (jcfg, tcfg, *_pair(jcfg, tcfg))


def test_config_is_the_published_one():
    """The port's copy registers the published config and its smoke variant:
    48 bidirectional layers at d 1280, hd 80, H = K = 16, fed
    embeddings."""
    assert ARCH in list_archs()
    for got, want in ((get_config(ARCH), jax_config(ARCH)),
                      (get_smoke_config(ARCH), jax_smoke(ARCH))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (48, 1280, 16, 16, 80,
                                                        5120, 504)
    assert cfg.is_encoder_only and not cfg.causal
    assert cfg.input_mode == "embeddings"
    assert (cfg.head_dim, cfg.head_dim) in flash_ops.HEAD_DIMS
    assert not supports_chunked_decode(cfg)


@pytest.mark.parametrize("gated", [False, True])
def test_mlp_matches_jax(gated):
    """The GeLU MLP (no gate, hubert's) and the SwiGLU one against the JAX
    ``mlp_forward`` on the same weights and inputs."""
    d, ff = 64, 256
    jw = jax_init_mlp(jax.random.PRNGKey(1), d, ff, jnp.float32, gated=gated)
    assert ("w_gate" in jw) == gated
    tw = {k: torch.from_numpy(np.array(v)) for k, v in jw.items()}
    x = np.random.default_rng(2).standard_normal((3, 17, d)).astype(
        np.float32) * 2.0
    want = np.asarray(jax_mlp_forward(jw, jnp.asarray(x)))
    got = mlp_forward(tw, torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= F32_TOL
    t = init_mlp(torch.Generator().manual_seed(0), d, ff, torch.float32,
                 "cpu", gated=gated)
    assert set(t) == set(jw)
    assert all(t[k].shape == jw[k].shape for k in t)


def test_gelu_erf_form_misses_the_tolerance():
    """``jax.nn.gelu`` is the tanh form by default; torch's default erf
    form differs from it by up to about 1e-3 of an activation, which after
    the down projection is still 1.6e-4 of the output's scale here, 8×
    F32_TOL, so the port asks for the tanh form."""
    jw = jax_init_mlp(jax.random.PRNGKey(1), 64, 256, jnp.float32,
                      gated=False)
    x = np.random.default_rng(2).standard_normal((3, 17, 64)).astype(
        np.float32) * 2.0
    want = np.asarray(jax_mlp_forward(jw, jnp.asarray(x)))
    up, down = (torch.from_numpy(np.array(jw[k])) for k in ("w_up",
                                                             "w_down"))
    erf = (F.gelu(torch.from_numpy(x) @ up) @ down).numpy()
    assert _rel(erf, want) > 5 * F32_TOL


def test_bridge_params_round_trip_exact(weights):
    """No embedding table (``needs_embed`` is false for an encoder fed
    embeddings), a head, MLPs without a gate; the tree crosses back
    exactly."""
    jcfg, tcfg, jp, tp = weights
    assert "embed" not in jp and "head" in jp
    assert tp.embed is None and tp.head is not None
    assert all("w_gate" not in b.mlp for b in tp.blocks)
    back = bridge.params_to_numpy(tp, tcfg)
    assert jax.tree.structure(jp) == jax.tree.structure(back)
    assert all(np.array_equal(np.asarray(x), y) for x, y in
               zip(jax.tree.leaves(jp), jax.tree.leaves(back)))
    init = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert init.embed is None
    assert [tuple(p.shape) for p in init.parameters()] == \
        [tuple(p.shape) for p in tp.parameters()]


@pytest.mark.parametrize("B,S", [(2, 24), (1, 1), (3, 50)])
def test_prefill_per_position_logits_match_jax(weights, B, S):
    """Per-position logits (B, S, V) of the bidirectional stack against
    JAX ``prefill`` on the same frames; no cache on either side."""
    jcfg, tcfg, jp, tp = weights
    x = _frames(jcfg, B, S, seed=S)
    jl, jc = jax_prefill(jp, {"embeddings": jnp.asarray(x)}, jcfg,
                         policy=J32)
    tl, tc = prefill(tp, {"embeddings": torch.from_numpy(x)}, tcfg,
                     policy=T32)
    assert jc is None and tc is None
    assert tuple(tl.shape) == (B, S, jcfg.vocab_size)
    assert tl.dtype == torch.float32
    assert _rel(tl, jl) <= F32_TOL


def test_bidirectional_frames_see_later_frames(weights):
    """Changing the last frame moves the first position's logits (a
    causal stack would leave them), in both packages alike."""
    jcfg, tcfg, jp, tp = weights
    x = _frames(jcfg, 1, 16, seed=3)
    y = x.copy()
    y[0, -1] += 1.0
    outs = [prefill(tp, {"embeddings": torch.from_numpy(a)}, tcfg,
                    policy=T32)[0][0, 0].numpy() for a in (x, y)]
    assert np.abs(outs[0] - outs[1]).max() > 1e-4
    jouts = [np.asarray(jax_prefill(jp, {"embeddings": jnp.asarray(a)}, jcfg,
                                    policy=J32)[0][0, 0]) for a in (x, y)]
    assert _rel(outs[1] - outs[0], jouts[1] - jouts[0]) <= 1e-3


def test_jax_and_port_attend_to_pad_frames_alike(weights):
    """A reference fault the port copies: neither package masks key
    padding in an encoder's prefill, so a clip right-padded to a longer
    clip's length in one batch attends to its pad frames.  A 15-frame clip
    beside a 24-frame one: its 15 positions' logits move from those it gets
    alone, in both packages, by the same amount within 1e-3 of the move;
    the 24-frame clip's are its own."""
    jcfg, tcfg, jp, tp = weights
    long_ = _frames(jcfg, 1, 24, seed=11)
    short = _frames(jcfg, 1, 15, seed=12)
    batch = np.zeros((2, 24, jcfg.d_model), np.float32)
    batch[0], batch[1, :15] = long_[0], short[0]

    def both(x):
        jl, _ = jax_prefill(jp, {"embeddings": jnp.asarray(x)}, jcfg,
                            policy=J32)
        tl, _ = prefill(tp, {"embeddings": torch.from_numpy(x)}, tcfg,
                        policy=T32)
        return np.asarray(jl), tl.numpy()

    jb, tb = both(batch)
    js, ts = both(short)
    jl_, tl_ = both(long_)
    moved_j, moved_t = jb[1, :15] - js[0], tb[1, :15] - ts[0]
    assert np.abs(moved_j).max() > 1e-2 * np.abs(js).max()
    assert _rel(moved_t, moved_j) <= 1e-3
    assert _rel(tb[0], jl_[0]) <= F32_TOL and _rel(tb[0], tl_[0]) <= F32_TOL


def test_full_width_two_layers_match_jax():
    """hubert's published widths (d 1280, hd 80, d_ff 5120) at 2 of its 48
    layers: per-position logits against JAX ``prefill``."""
    jcfg = jax_config(ARCH).scaled(n_layers=2)
    tcfg = get_config(ARCH).scaled(n_layers=2)
    jp, tp = _pair(jcfg, tcfg, seed=5)
    x = _frames(jcfg, 1, 40, seed=6)
    jl, _ = jax_prefill(jp, {"embeddings": jnp.asarray(x)}, jcfg, policy=J32)
    tl, _ = prefill(tp, {"embeddings": torch.from_numpy(x)}, tcfg,
                    policy=T32)
    assert tuple(tl.shape) == (1, 40, 504)
    assert _rel(tl, jl) <= F32_TOL


@pytest.mark.parametrize("B,S,H", [(1, 256, 4), (2, 128, 2)])
def test_plain_bidirectional_flash_at_hd80_matches_pallas(B, S, H):
    """The flash wrapper's plain version, non-causal at hubert's (80, 80)
    with H = K, against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(S + H)
    q, k, v = (rng.standard_normal((B, H, S, 80)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(flash_attention_bhsd(
        *(jnp.asarray(a) for a in (q, k, v)), causal=False, interpret=True))
    got = flash_ops.flash_attention(
        *(torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)),
        causal=False).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


def test_decode_and_chunk_steps_refused(weights):
    """Without an embedding table there is nothing to decode tokens
    through: both steps raise a ``ValueError`` that names the model."""
    _, tcfg, _, tp = weights
    caches = init_decode_caches(tcfg, 1, 16, dtype=torch.float32,
                                device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match=tcfg.name):
        decode_step(tp, tok, caches, 0, tcfg, policy=T32)
    with pytest.raises(ValueError, match=tcfg.name):
        chunk_step(tp, tok, caches, 0, tcfg, policy=T32)


def test_engine_refuses_an_encoder(weights):
    """The port's engine refuses hubert at construction with a
    ``ValueError`` that names it; the JAX engine cannot serve it either
    (its prefill reads the embedding table hubert does not have)."""
    jcfg, tcfg, jp, tp = weights
    with pytest.raises(ValueError, match=tcfg.name):
        ServingEngine(tcfg, tp, tcore.FCFSScheduler(),
                      EngineConfig(max_slots=2, s_max=64,
                                   kv_pool_tokens=512, buckets=(32, 64)),
                      device="cpu")
    jeng = JaxEngine(jcfg, jp, jcore.FCFSScheduler(),
                     JaxEngineConfig(max_slots=2, s_max=64,
                                     kv_pool_tokens=512, buckets=(32, 64)))
    with pytest.raises(KeyError, match="embed"):
        jeng.run([jcore.Request(prompt_len=10, arrival_time=0.0,
                                max_new_tokens=2)], max_steps=50)
