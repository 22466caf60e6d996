"""Sliding-window attention in the PyTorch port on the CPU, against the JAX
package: the ring cache of h2o-danube-1.8b (every layer a window) and
gemma3-4b (five local layers of a window to one global layer).

A ring layer's decode cache holds min(window, s_max) slots, position p in
slot ``p % W``; the port's decode hands the ring to the paged kernel as a
page pool with ``seq_lens = min(pos + 1, W)``, where the JAX package masks
the slots whose position is negative.  On CPU tensors the port runs the
plain versions of its kernels.  Weights come from the JAX initializer and
cross through ``bridge``.  Tolerances are those of tests/test_kernels.py:
2e-5 in f32 and 3e-2 in bf16, relative to the logits' scale.

The JAX package builds a ring from the prefill's padded length, which is
wrong for a row shorter than a bucket longer than the window; the port
builds it from each row's true length.  ``test_jax_ring_fault_*`` shows
both, and the engine parity runs on prompts and buckets no longer than
the window, where the JAX ring is right.
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
from repro.models import init_decode_caches as jax_init_caches
from repro.models import init_params as jax_init
from repro.models import prefill as jax_prefill
from repro.models.attention import gqa_decode_ring as jax_decode_ring
from repro.models.attention import init_attention as jax_init_attention
from repro.models.attention import \
    ring_cache_from_prefill as jax_ring_from_prefill
from repro.models.model import pad_prefill_caches
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.models import (DtypePolicy, decode_step, init_decode_caches,
                                prefill, supports_chunked_decode)
from repro_torch.models.attention import (gqa_decode_ring,
                                          ring_cache_from_prefill)
from repro_torch.models.transformer import (check_supported, layer_kinds,
                                            stack_layout, uses_ring)
from repro_torch.serving import EngineConfig, ServingEngine

ARCHS = ["h2o-danube-1.8b", "gemma3-4b"]
F32_TOL, BF16_TOL = 2e-5, 3e-2     # tests/test_kernels.py:36-39
J32 = JaxPolicy(jnp.float32, jnp.float32, jnp.float32)
T32 = DtypePolicy(torch.float32, torch.float32, torch.float32)
JB16 = JaxPolicy(jnp.bfloat16, jnp.bfloat16, jnp.float32)
TB16 = DtypePolicy(torch.bfloat16, torch.bfloat16, torch.float32)


def _rel(a, b) -> float:
    """Largest difference relative to the reference's largest magnitude."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np(t):
    return np.asarray(jnp.asarray(t, jnp.float32))


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    """(arch, JAX config, port config, JAX params, port params), f32."""
    arch = request.param
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    return arch, jcfg, tcfg, jp, tp


def _to_decode(tcfg, prefill_caches, batch: int, s_max: int, dtype):
    """Zero decode caches with each prefill entry's rows at its front, as
    the engine's ``_write_slot`` lays them."""
    caches = init_decode_caches(tcfg, batch, s_max, dtype=dtype,
                                device="cpu")
    for dst, src in zip(caches, prefill_caches):
        for name, t in src.items():
            dst[name][:, :t.shape[1]].copy_(t)
    return caches


# ---- configs and layout ---------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_published_ones(arch):
    """The port's copies register the JAX configs, smoke included, and its
    stack takes them: every h2o-danube layer and gemma3's 29 local layers
    of 34 decode over rings."""
    assert arch in list_archs()
    for full in (True, False):
        got = get_config(arch) if full else get_smoke_config(arch)
        want = jax_config(arch) if full else jax_smoke(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        check_supported(got)
        assert not supports_chunked_decode(got)
    cfg = get_config(arch)
    rings = [uses_ring(cfg, k) for k in layer_kinds(cfg)]
    if arch == "gemma3-4b":
        assert (cfg.head_dim, cfg.n_heads // cfg.n_kv_heads, cfg.window) == \
            (256, 2, 1024)
        assert stack_layout(cfg) == (0, 5, 4) and sum(rings) == 29
        assert cfg.tie_embeddings and cfg.vocab_size == 262144
    else:
        assert (cfg.head_dim, cfg.n_heads // cfg.n_kv_heads, cfg.window) == \
            (80, 4, 4096)
        assert all(rings) and len(rings) == 24


# ---- the ring functions ---------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_decode_ring_matches_jax_across_three_windows(arch):
    """3W decode steps of one ring layer, two rows W/2 apart, so that the
    ring wraps twice: outputs within 2e-5 of the JAX function's, and the
    ring equal to its ring."""
    cfg = jax_smoke(arch)
    tcfg = get_smoke_config(arch)
    W = cfg.window
    jpar = jax_init_attention(jax.random.PRNGKey(3), cfg, jnp.float32)
    tpar = {k: torch.from_numpy(np.array(v)) for k, v in jpar.items()}
    shape = (2, W, cfg.n_kv_heads, cfg.head_dim)
    jc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tc = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    rng = np.random.default_rng(1)
    pos = np.array([0, W // 2], dtype=np.int32)
    for _ in range(3 * W):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jc = jax_decode_ring(jpar, jnp.asarray(x), jc, jnp.asarray(pos),
                                 cfg, window=W)
        ty, tc = gqa_decode_ring(tpar, torch.from_numpy(x), tc,
                                 torch.from_numpy(pos), tcfg, window=W)
        assert _rel(ty.numpy(), jy) <= F32_TOL
        pos = pos + 1
    for name in ("k", "v"):
        assert _rel(tc[name].numpy(), jc[name]) <= F32_TOL


@pytest.mark.parametrize("S,lens", [(12, None), (16, None), (40, None),
                                    (12, [12, 5]), (16, [16, 1])])
def test_ring_from_prefill_matches_jax_where_its_ring_is_right(S, lens):
    """The port's ring equals the JAX one for full-length rows (any S) and
    for padded rows when S <= W (W = 16): slot for slot where a position
    is kept; the port's other slots are zero."""
    W = 16
    rng = np.random.default_rng(S)
    kv = {n: rng.standard_normal((2, S, 2, 8)).astype(np.float32)
          for n in ("k", "v")}
    want = jax_ring_from_prefill({n: jnp.asarray(a) for n, a in kv.items()},
                                 W)
    got = ring_cache_from_prefill({n: torch.from_numpy(a)
                                   for n, a in kv.items()}, W,
                                  None if lens is None else torch.tensor(lens))
    L = np.full(2, S) if lens is None else np.asarray(lens)
    for name in ("k", "v"):
        g, w = got[name].numpy(), np.asarray(want[name])
        assert g.shape == w.shape == (2, min(W, S), 2, 8)
        for b in range(2):
            for s in range(g.shape[1]):
                if s < L[b] or L[b] >= g.shape[1]:
                    np.testing.assert_array_equal(g[b, s], w[b, s])
                else:
                    assert not g[b, s].any()


def test_ring_from_prefill_keeps_each_rows_window():
    """Rows of 20 and 7 tokens in a bucket of 40, W = 16: row 0 keeps
    positions 4 .. 19, each at slot pos % 16, row 1 positions 0 .. 6 at
    their own slots; every other slot is zero."""
    k = torch.arange(2 * 40, dtype=torch.float32).reshape(2, 40, 1, 1)
    ring = ring_cache_from_prefill({"k": k, "v": -k}, 16,
                                   torch.tensor([20, 7]))
    for b, L in ((0, 20), (1, 7)):
        want = torch.zeros(16)
        for p in range(max(0, L - 16), L):
            want[p % 16] = k[b, p, 0, 0]
        assert torch.equal(ring["k"][b, :, 0, 0], want)
        assert torch.equal(ring["v"][b, :, 0, 0], -want)


# ---- the model --------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_three_windows_of_decode_match_jax(weights, dtype):
    """One prefill of two rows longer than the window (no padding, where
    the JAX ring is right), then 3W greedy decode steps: every step's
    logits within 2e-5 (f32) or 3e-2 (bf16) of JAX's, relative to their
    scale.  f32 also keeps greedy tokens and caches equal; bf16 feeds both
    JAX's greedy tokens, so that a near-tie cannot part the runs."""
    arch, jcfg, tcfg, jp, tp = weights
    W = tcfg.window
    S = W + 8
    steps = 3 * W
    s_max = S + steps + 8
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    if dtype == "float32":
        jpol, tpol, tdt = J32, T32, torch.float32
    else:
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
        tp = bridge.params_from_jax(jax.tree.map(_np, jp), tcfg,
                                    device="cpu").to(torch.bfloat16)
        jpol, tpol, tdt = JB16, TB16, torch.bfloat16
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, S)).astype(np.int32)
    jl, jc = jax_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                         policy=jpol)
    tl, tc = prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                     policy=tpol)
    assert _rel(tl.numpy(), _np(jl)) <= tol
    jc = pad_prefill_caches(jc, jcfg, s_max)
    tc = _to_decode(tcfg, tc, 2, s_max, tdt)
    pos = np.array([S, S], dtype=np.int32)
    jdecode = jax.jit(lambda p, t, c, q: jax_decode(p, t, c, q, jcfg,
                                                     policy=jpol))
    for _ in range(steps):
        jtok = np.asarray(jnp.argmax(jl[:, 0], -1))[:, None].astype(np.int32)
        ttok = tl[:, 0].argmax(-1, keepdim=True).to(torch.int32)
        if dtype == "float32":
            assert np.array_equal(jtok, ttok.numpy())
        jl, jc = jdecode(jp, jnp.asarray(jtok), jc, jnp.asarray(pos))
        tl, tc = decode_step(tp, torch.from_numpy(jtok), tc, pos, tcfg,
                             policy=tpol)
        assert _rel(tl.numpy(), _np(jl)) <= tol
        pos = pos + 1
    if dtype == "float32":
        got = bridge.caches_to_numpy(tc, tcfg)
        for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(got)):
            assert a.shape == b.shape
            assert _rel(b, a) <= F32_TOL


def test_bridge_ring_caches_round_trip_exact():
    """gemma3 at 14 layers, two periods of 6 and a tail of 2: a JAX decode
    cache tree of random values (rings of 16 slots, global layers of 64)
    crosses to the port layer by layer — layer j of period p is layer p·6
    + j — and back, exactly."""
    jcfg = jax_smoke("gemma3-4b").scaled(n_layers=14)
    tcfg = get_smoke_config("gemma3-4b").scaled(n_layers=14)
    assert stack_layout(tcfg) == (0, 2, 2)
    tree = jax.tree.map(np.asarray, jax_init_caches(jcfg, 3, 64,
                                                    dtype=jnp.float32))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), tree)
    layers = bridge.caches_from_jax(tree, tcfg, device="cpu")
    kinds = layer_kinds(tcfg)
    for i, (layer, kind) in enumerate(zip(layers, kinds)):
        assert layer["k"].shape[1] == (16 if kind == "local" else 64)
        want = (tree["stack"][f"slot_{i % 6}"]["k"][i // 6] if i < 12
                else tree["tail"][i - 12]["k"])
        np.testing.assert_array_equal(layer["k"].numpy(), want)
    back = bridge.caches_to_numpy(layers, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


# ---- the engine -------------------------------------------------------------

def _window_requests(pkg, W: int, n: int = 6, seed: int = 0):
    """Prompts of W/4 .. W tokens (never longer than the window), each
    decoding 2W tokens past it, so that every ring wraps."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(seed * 100 + i)
        pl = int(rng.integers(W // 4, W + 1))
        out.append(pkg.Request(
            request_id=i, arrival_time=0.0, prompt_len=pl,
            max_new_tokens=2 * W,
            prompt_tokens=rng.integers(0, 256, size=(pl,)).astype(np.int32)))
    return out


def _ewsjf(pkg):
    # re-optimisation needs 100 finished requests, so the queue layout stays
    # the initial one in both engines
    return pkg.EWSJFScheduler(pkg.EWSJFConfig(min_history=100,
                                              reopt_interval=1e9))


def _window_engine_config(W: int) -> dict:
    """Buckets no longer than the window, slots long enough for 3W."""
    return dict(max_slots=4, s_max=4 * W, kv_pool_tokens=16 * W,
                buckets=(W // 2, W), max_prefill_tokens=4 * W)


def test_engine_matches_jax(weights):
    """EWSJF serves of 6 requests whose prompts and buckets are no longer
    than the window, each decoding 2W tokens: greedy tokens, dispatch order
    and pool accounting equal the JAX engine's, and the slot caches (rings
    and gemma3's global layer) hold its values within 2e-5."""
    arch, jcfg, tcfg, jp, tp = weights
    W = tcfg.window
    ecfg = _window_engine_config(W)
    jeng = JaxEngine(jcfg, jp, _ewsjf(jcore), JaxEngineConfig(**ecfg))
    jeng.run(_window_requests(jcore, W), max_steps=4000)
    teng = ServingEngine(tcfg, tp, _ewsjf(tcore), EngineConfig(**ecfg),
                         device="cpu")
    teng.run(_window_requests(tcore, W), max_steps=4000)
    assert len(teng.finished) == len(jeng.finished) == 6
    assert teng.output_tokens == jeng.output_tokens
    assert all(len(v) == 2 * W for v in teng.output_tokens.values())
    assert [rid for _, rid in teng.dispatch_log] == \
        [rid for _, rid in jeng.dispatch_log]
    assert teng.pool.free_blocks == jeng.pool.free_blocks
    got = bridge.caches_to_numpy(teng.caches, tcfg)
    for a, b in zip(jax.tree.leaves(jeng.caches), jax.tree.leaves(got)):
        assert a.shape == b.shape
        assert _rel(b, a) <= F32_TOL


@pytest.mark.parametrize("mode", [dict(chunk_prefill_tokens=16),
                                  dict(enable_prefix_cache=True)])
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_and_prefix_modes_refused_as_in_jax(arch, mode):
    """Both engines raise ValueError for ring stacks in chunked-prefill and
    in prefix-cache mode."""
    ecfg = dict(max_slots=2, s_max=64, kv_pool_tokens=1024, **mode)
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(ValueError):
        JaxEngine(jcfg, jp, jcore.FCFSScheduler(), JaxEngineConfig(**ecfg))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    with pytest.raises(ValueError):
        ServingEngine(tcfg, tp, tcore.FCFSScheduler(), EngineConfig(**ecfg),
                      device="cpu")


# ---- the reference fault ----------------------------------------------------

@pytest.mark.parametrize("L,bucket", [(20, 32), (17, 64)])
def test_jax_ring_fault_and_port_repair(L, bucket):
    """gemma3 smoke (W = 16): one greedy decode step after a prefill of an
    L-token prompt right-padded to a bucket longer than the window.  The
    JAX ring of the padded prefill parts from the exact-length decode by at
    least 0.1 of the logits' scale (it keeps pads and loses positions
    still in the window); the port, in the same padded batch beside a
    full-length row, builds each row's ring from its true length and gives
    the exact-length JAX logits within 2e-5."""
    jcfg, tcfg = jax_smoke("gemma3-4b"), get_smoke_config("gemma3-4b")
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    s_max = 96
    rng = np.random.default_rng(L)
    prompt = rng.integers(0, jcfg.vocab_size, (1, L)).astype(np.int32)
    padded = np.zeros((1, bucket), np.int32)
    padded[:, :L] = prompt
    # the exact-length JAX run: the reference
    jl, jc = jax_prefill(jp, {"tokens": jnp.asarray(prompt)}, jcfg,
                         policy=J32)
    tok = np.asarray(jnp.argmax(jl[:, 0], -1))[:, None].astype(np.int32)
    exact, _ = jax_decode(jp, jnp.asarray(tok),
                          pad_prefill_caches(jc, jcfg, s_max),
                          jnp.asarray([L], jnp.int32), jcfg, policy=J32)
    # the JAX ring of the padded prefill
    _, jpc = jax_prefill(jp, {"tokens": jnp.asarray(padded)}, jcfg,
                         policy=J32)
    fault, _ = jax_decode(jp, jnp.asarray(tok),
                          pad_prefill_caches(jpc, jcfg, s_max),
                          jnp.asarray([L], jnp.int32), jcfg, policy=J32)
    assert _rel(fault, exact) >= 0.1
    # the port: the padded row beside a full-length one
    other = rng.integers(0, jcfg.vocab_size, (1, bucket)).astype(np.int32)
    batch = torch.from_numpy(np.concatenate([padded, other]))
    _, tc = prefill(tp, {"tokens": batch}, tcfg, policy=T32,
                    true_lens=torch.tensor([L, bucket]))
    tc = _to_decode(tcfg, tc, 2, s_max, torch.float32)
    toks = torch.from_numpy(np.array([[tok[0, 0]], [0]], np.int32))
    got, _ = decode_step(tp, toks, tc, np.array([L, bucket], np.int32), tcfg,
                         policy=T32)
    assert _rel(got[:1].numpy(), exact) <= F32_TOL


def test_port_engine_mixed_lengths_match_each_row_alone():
    """The engine twin of the fault (gemma3 smoke, W = 16): prompts of 20,
    40 and 9 tokens prefilled together in one bucket of 64 give the greedy
    tokens each prompt gives served alone at its exact length."""
    jcfg, tcfg = jax_smoke("gemma3-4b"), get_smoke_config("gemma3-4b")
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 256, size=(n,)).astype(np.int32)
               for n in (20, 40, 9)]

    def serve(idx, buckets):
        reqs = [tcore.Request(request_id=i, arrival_time=0.0,
                              prompt_len=len(prompts[i]), max_new_tokens=12,
                              prompt_tokens=prompts[i]) for i in idx]
        eng = ServingEngine(tcfg, tp, tcore.FCFSScheduler(), EngineConfig(
            max_slots=4, s_max=96, kv_pool_tokens=2048, buckets=buckets,
            max_prefill_tokens=1024), device="cpu")
        eng.run(reqs, max_steps=2000)
        assert eng.prefill_batches == 1
        return eng.output_tokens

    together = serve([0, 1, 2], (64,))
    for i, p in enumerate(prompts):
        assert serve([i], (len(p),))[i] == together[i]
