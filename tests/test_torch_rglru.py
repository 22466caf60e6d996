"""The RG-LRU hybrid family (recurrentgemma-9b) in the PyTorch port on the
CPU, against the JAX package.

recurrentgemma's layers repeat (rglru, rglru, local): Griffin's recurrent
block with a SwiGLU MLP, and a local MQA layer over a ring cache (the
sliding-window path of ``tests/test_torch_ring.py``).  Its smoke config has
6 layers (two periods, no tail), d 64, RG-LRU width 64, 4 heads of 16 on 1
KV head, window 16; the 8-layer variant adds a tail of 2 RG-LRU layers, as
the full config's 38 = 12 × 3 + 2.  Weights come from the JAX initializer
and cross through ``bridge``.  On CPU tensors the port runs the plain
versions of its kernels.  Tolerances are those of tests/test_kernels.py:
2e-5 in f32 and 3e-2 in bf16, relative to the compared values' scale.

The JAX prefill reads a right-padded row's RG-LRU state and conv tail at
the padded length; the port reads them at each row's true length.
``test_jax_rglru_padded_row_fault_and_port_repair`` shows both, and the
engine parity runs on equal-length prompts, where the JAX state is right.
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
from repro.models.model import pad_prefill_caches
from repro.models.rglru import init_rglru as jax_init_rglru
from repro.models.rglru import rglru_decode as jax_rglru_decode
from repro.models.rglru import rglru_forward as jax_rglru_forward
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.models import (DtypePolicy, decode_step, init_decode_caches,
                                prefill, supports_chunked_decode)
from repro_torch.models.rglru import (init_rglru, init_rglru_cache,
                                      linear_scan, rglru_decode,
                                      rglru_forward)
from repro_torch.models.transformer import (check_supported, layer_kinds,
                                            stack_layout, uses_ring)
from repro_torch.serving import EngineConfig, ServingEngine

ARCH = "recurrentgemma-9b"
F32_TOL, BF16_TOL = 2e-5, 3e-2     # tests/test_kernels.py:36-39
J32 = JaxPolicy(jnp.float32, jnp.float32, jnp.float32)
T32 = DtypePolicy(torch.float32, torch.float32, torch.float32)


def _rel(a, b) -> float:
    """Largest difference relative to the reference's largest magnitude."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np(t):
    return np.asarray(jnp.asarray(t, jnp.float32))


def _cfgs(n_layers: int):
    jcfg, tcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    return jcfg.scaled(n_layers=n_layers), tcfg.scaled(n_layers=n_layers)


@pytest.fixture(scope="module", params=[6, 8], ids=["smoke", "tail"])
def weights(request):
    """(JAX config, port config, JAX params, port params), f32: the smoke
    config (6 layers, no tail) or its 8-layer variant (a tail of 2)."""
    jcfg, tcfg = _cfgs(request.param)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    return jcfg, tcfg, jp, tp


def _to_decode(tcfg, prefill_caches, batch: int, s_max: int, dtype):
    """Zero decode caches with each prefill entry laid at its front, as the
    engine's ``_write_slot`` lays them (RG-LRU entries whole)."""
    caches = init_decode_caches(tcfg, batch, s_max, dtype=dtype,
                                device="cpu")
    for dst, src in zip(caches, prefill_caches):
        for name, t in src.items():
            dst[name][:, :t.shape[1]].copy_(t)
    return caches


# ---- config and layout ------------------------------------------------------

def test_config_is_the_published_one():
    """The port's copy registers the JAX config and its smoke variant; the
    full stack is 12 periods of (rglru, rglru, local) and a tail of 2 RG-LRU
    layers — 26 RG-LRU and 12 local MQA layers of hd 256, G = 16, window
    2048 — and refuses chunked decode, as JAX's does."""
    assert ARCH in list_archs()
    for got, want in ((get_config(ARCH), jax_config(ARCH)),
                      (get_smoke_config(ARCH), jax_smoke(ARCH))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        check_supported(got)
        assert not supports_chunked_decode(got)
    cfg = get_config(ARCH)
    kinds = layer_kinds(cfg)
    assert stack_layout(cfg) == (0, 12, 2)
    assert kinds.count("rglru") == 26 and kinds.count("local") == 12
    assert kinds[-2:] == ["rglru", "rglru"]
    assert all(uses_ring(cfg, k) == (k == "local") for k in kinds)
    assert (cfg.head_dim, cfg.n_heads // cfg.n_kv_heads, cfg.window,
            cfg.rnn_width, cfg.conv_width) == (256, 16, 2048, 4096, 4)
    assert stack_layout(_cfgs(8)[1]) == (0, 2, 2)


def test_init_has_the_jax_leaves_and_cache():
    """``init_rglru`` makes the JAX initializer's 9 leaves at its shapes,
    gate biases and Λ in f32 whatever the weights' type; the cache is ``h``
    in f32 and the conv state in the cache type."""
    jcfg, tcfg = _cfgs(6)
    jpar = jax_init_rglru(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    tpar = init_rglru(torch.Generator().manual_seed(0), tcfg, torch.bfloat16,
                      "cpu")
    assert set(tpar) == set(jpar)
    for k, v in jpar.items():
        assert tuple(tpar[k].shape) == v.shape
        assert (tpar[k].dtype == torch.float32) == (v.dtype == jnp.float32)
    c = init_rglru_cache(tcfg, 3, torch.bfloat16, "cpu")
    assert c["h"].dtype == torch.float32 and c["h"].shape == (3, 64)
    assert c["conv"].dtype == torch.bfloat16 and c["conv"].shape == (3, 3, 64)


# ---- the scan and the block -------------------------------------------------

@pytest.mark.parametrize("S", [1, 2, 7, 64, 100])
def test_log_depth_scan_matches_sequential_loop(S):
    """The Hillis–Steele scan against ``h_t = a_t h_{t-1} + b_t`` step by
    step in f64, decays as RG-LRU's gates make them (0 < a < 1)."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.0, 1.0, (2, S, 8)).astype(np.float32)
    b = rng.standard_normal((2, S, 8)).astype(np.float32)
    want = np.zeros((2, S, 8))
    h = np.zeros((2, 8))
    for t in range(S):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        want[:, t] = h
    got = linear_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert _rel(got, want) <= 1e-6


def _block(dtype):
    """(JAX config, port config, JAX params, port params) of one RG-LRU
    block in ``dtype`` (gate biases and Λ f32, as initialized)."""
    jcfg, tcfg = _cfgs(6)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jpar = jax_init_rglru(jax.random.PRNGKey(3), jcfg, jdt)
    tpar = {k: torch.from_numpy(_np(v).copy()).to(
        torch.float32 if v.dtype == jnp.float32 else dtype)
        for k, v in jpar.items()}
    return jcfg, tcfg, jpar, tpar


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_forward_and_decode_match_jax(dtype):
    """``rglru_forward`` with its state, then 12 ``rglru_decode`` steps, on
    the same inputs as the JAX functions: outputs and the ``{"h", "conv"}``
    state within 2e-5 (f32) or 3e-2 (bf16) of their scale; the port's cache
    is updated in place."""
    jcfg, tcfg, jpar, tpar = _block(dtype)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 21, jcfg.d_model)).astype(np.float32)
    jy, jst = jax_rglru_forward(jpar, jnp.asarray(x, jdt), jcfg,
                                return_state=True)
    ty, tst = rglru_forward(tpar, torch.from_numpy(x).to(dtype), tcfg,
                            return_state=True)
    assert _rel(ty.float(), _np(jy)) <= tol
    for name in ("h", "conv"):
        assert _rel(tst[name].float(), _np(jst[name])) <= tol
    assert tst["h"].dtype == torch.float32
    cache = init_rglru_cache(tcfg, 2, dtype, "cpu")
    for name in ("h", "conv"):
        cache[name].copy_(tst[name])
    for _ in range(12):
        xt = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jy, jst = jax_rglru_decode(jpar, jnp.asarray(xt, jdt), jst, jcfg)
        ty, out = rglru_decode(tpar, torch.from_numpy(xt).to(dtype), cache,
                               tcfg)
        assert out is cache
        assert _rel(ty.float(), _np(jy)) <= tol
        for name in ("h", "conv"):
            assert _rel(cache[name].float(), _np(jst[name])) <= tol


def test_bf16_prefill_state_is_rounded_as_jax():
    """In bf16 the prefill's f32 state is the scan's ``h`` rounded to bf16
    and read back, as JAX's ``h.astype(x.dtype)[:, -1].astype(f32)``: every
    element is a bf16 value, and the state lies within 2^-7 of its scale of
    JAX's (one bf16 step; the two packages' bf16 products part there), far
    inside the block's 3e-2."""
    jcfg, tcfg, jpar, tpar = _block(torch.bfloat16)
    x = np.random.default_rng(0).standard_normal(
        (2, 21, jcfg.d_model)).astype(np.float32)
    _, jst = jax_rglru_forward(jpar, jnp.asarray(x, jnp.bfloat16), jcfg,
                               return_state=True)
    _, tst = rglru_forward(tpar, torch.from_numpy(x).to(torch.bfloat16), tcfg,
                           return_state=True)
    h = tst["h"]
    assert h.dtype == torch.float32
    assert torch.equal(h, h.to(torch.bfloat16).float())
    assert _rel(h, _np(jst["h"])) <= 2 ** -7


# ---- the model --------------------------------------------------------------

def test_prefill_and_three_windows_of_decode_match_jax(weights):
    """f32: one prefill of two rows longer than the window (no padding,
    where the JAX state and ring are right), then 3W greedy decode steps,
    so that every local layer's ring wraps twice: every step's logits
    within 2e-5 of JAX's, relative to their scale, greedy tokens equal, and
    the caches (RG-LRU state, conv tails, rings) within 2e-5 at the end.
    bf16 is held per block (``test_rglru_forward_and_decode_match_jax``):
    through the model, the port's and JAX's bf16 logits each lie 0.013-0.018
    of their scale from f32 on the same bf16 weights (smoke prefill), and
    the two roundings part by 0.02-0.05 over the 3W steps."""
    jcfg, tcfg, jp, tp = weights
    W = tcfg.window
    S = W + 8
    steps = 3 * W
    s_max = S + steps + 8
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, S)).astype(np.int32)
    jl, jc = jax_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, policy=J32)
    tl, tc = prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                     policy=T32)
    assert _rel(tl.numpy(), _np(jl)) <= F32_TOL
    jc = pad_prefill_caches(jc, jcfg, s_max)
    tc = _to_decode(tcfg, tc, 2, s_max, torch.float32)
    pos = np.array([S, S], dtype=np.int32)
    jdecode = jax.jit(lambda p, t, c, q: jax_decode(p, t, c, q, jcfg,
                                                     policy=J32))
    for _ in range(steps):
        jtok = np.asarray(jnp.argmax(jl[:, 0], -1))[:, None].astype(np.int32)
        ttok = tl[:, 0].argmax(-1, keepdim=True).to(torch.int32)
        assert np.array_equal(jtok, ttok.numpy())
        jl, jc = jdecode(jp, jnp.asarray(jtok), jc, jnp.asarray(pos))
        tl, tc = decode_step(tp, ttok, tc, pos, tcfg, policy=T32)
        assert _rel(tl.numpy(), _np(jl)) <= F32_TOL
        pos = pos + 1
    got = bridge.caches_to_numpy(tc, tcfg)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, jc))
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(got)):
        assert a.shape == b.shape
        assert _rel(b, a) <= F32_TOL


def test_bridge_round_trips_exact(weights):
    """The parameter tree (every RG-LRU leaf, the tail's blocks) and a
    decode-cache tree of random values (``{"h", "conv"}`` and rings) cross
    to the port layer by layer and back exactly; the tail's layers are the
    last ones of the stack."""
    jcfg, tcfg, jp, tp = weights
    kinds = layer_kinds(tcfg)
    assert [b.kind for b in tp.blocks] == kinds
    leaves = {"w_gate_in", "w_x_in", "conv_w", "w_a", "b_a", "w_i", "b_i",
              "lam", "w_out"}
    assert all(b.mlp is not None for b in tp.blocks)
    assert all(set(b.mixer) == leaves for b in tp.blocks if b.kind == "rglru")
    back = bridge.params_to_numpy(tp, tcfg)
    assert jax.tree.structure(jp) == jax.tree.structure(back)
    assert all(np.array_equal(np.asarray(x), y) for x, y in
               zip(jax.tree.leaves(jp), jax.tree.leaves(back)))
    _, n_periods, tail = stack_layout(tcfg)
    for i in range(tail):
        np.testing.assert_array_equal(
            tp.blocks[3 * n_periods + i].mixer["lam"].numpy(),
            np.asarray(jp["blocks"]["tail"][i]["mixer"]["lam"]))
    tree = jax.tree.map(np.asarray, jax_init_caches(jcfg, 3, 40,
                                                    dtype=jnp.float32))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), tree)
    layers = bridge.caches_from_jax(tree, tcfg, device="cpu")
    for layer, kind in zip(layers, kinds):
        assert set(layer) == ({"h", "conv"} if kind == "rglru"
                              else {"k", "v"})
    back = bridge.caches_to_numpy(layers, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


# ---- the engine -------------------------------------------------------------

def _equal_length_requests(pkg, W: int, n: int = 6, seed: int = 0):
    """Prompts of W - 4 tokens each (equal lengths: no prefill padding,
    where the JAX state is right), each decoding 2W tokens, so that every
    ring wraps."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(seed * 100 + i)
        out.append(pkg.Request(
            request_id=i, arrival_time=0.0, prompt_len=W - 4,
            max_new_tokens=2 * W,
            prompt_tokens=rng.integers(0, 256, size=(W - 4,)).astype(
                np.int32)))
    return out


def _ewsjf(pkg):
    # re-optimisation needs 100 finished requests, so the queue layout stays
    # the initial one in both engines
    return pkg.EWSJFScheduler(pkg.EWSJFConfig(min_history=100,
                                              reopt_interval=1e9))


def test_engine_matches_jax(weights):
    """EWSJF serves of 6 equal-length requests (prompts unpadded: the hybrid
    family's ``pad_prompts`` is off in both engines), each decoding 2W
    tokens: greedy tokens, dispatch order and pool accounting equal the JAX
    engine's, and the slot caches (RG-LRU state and conv tails, rings) hold
    its values within 2e-5."""
    jcfg, tcfg, jp, tp = weights
    W = tcfg.window
    ecfg = dict(max_slots=4, s_max=4 * W, kv_pool_tokens=16 * W,
                buckets=(W // 2, W), max_prefill_tokens=4 * W)
    jeng = JaxEngine(jcfg, jp, _ewsjf(jcore), JaxEngineConfig(**ecfg))
    jeng.run(_equal_length_requests(jcore, W), max_steps=4000)
    teng = ServingEngine(tcfg, tp, _ewsjf(tcore), EngineConfig(**ecfg),
                         device="cpu")
    teng.run(_equal_length_requests(tcore, W), max_steps=4000)
    assert not teng.e.pad_prompts and not jeng.e.pad_prompts
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
def test_chunked_and_prefix_modes_refused_as_in_jax(mode):
    """Both engines raise ValueError for the hybrid stack in chunked-prefill
    and in prefix-cache mode."""
    ecfg = dict(max_slots=2, s_max=64, kv_pool_tokens=1024, **mode)
    jcfg, tcfg = _cfgs(6)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(ValueError):
        JaxEngine(jcfg, jp, jcore.FCFSScheduler(), JaxEngineConfig(**ecfg))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    with pytest.raises(ValueError):
        ServingEngine(tcfg, tp, tcore.FCFSScheduler(), EngineConfig(**ecfg),
                      device="cpu")


# ---- the reference fault ----------------------------------------------------

def test_jax_rglru_padded_row_fault_and_port_repair():
    """A 12-token row padded to 17 beside a 17-token row, through one
    RG-LRU block of the smoke config (f32).  JAX's state of the padded row
    (``h`` and the conv tail read at the padded length) parts from the same
    row run alone by at least half the state's own scale; the port's, with
    ``true_lens``, equals the row alone within 2e-5, and so does its
    output at the real positions."""
    jcfg, tcfg, jpar, tpar = _block(torch.float32)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 17, jcfg.d_model)).astype(np.float32)
    _, alone = jax_rglru_forward(jpar, jnp.asarray(x[:1, :12]), jcfg,
                                 return_state=True)
    _, padded = jax_rglru_forward(jpar, jnp.asarray(x), jcfg,
                                  return_state=True)
    h_alone = np.asarray(alone["h"][0])
    err = float(np.abs(np.asarray(padded["h"][0]) - h_alone).max())
    scale = float(np.abs(h_alone).max())
    print(f"JAX padded-row RG-LRU state: max |h - h_alone| {err:.3g}, "
          f"max |h_alone| {scale:.3g}")
    assert err >= 0.5 * scale
    ty, tst = rglru_forward(tpar, torch.from_numpy(x), tcfg,
                            true_lens=torch.tensor([12, 17]),
                            return_state=True)
    jy_alone = jax_rglru_forward(jpar, jnp.asarray(x[:1, :12]), jcfg)
    assert _rel(tst["h"][0].numpy(), h_alone) <= F32_TOL
    assert _rel(tst["conv"][0].numpy(), np.asarray(alone["conv"][0])) \
        <= F32_TOL
    assert _rel(ty[0, :12].numpy(), np.asarray(jy_alone[0])) <= F32_TOL
    # the full-length row is unchanged by its neighbour's true length
    _, full = jax_rglru_forward(jpar, jnp.asarray(x[1:]), jcfg,
                                return_state=True)
    assert _rel(tst["h"][1].numpy(), np.asarray(full["h"][0])) <= F32_TOL


def test_jax_padded_prefill_decodes_wrong_port_decodes_right():
    """The fault at the model (smoke config, W = 16): one greedy decode step
    after a 12-token prompt right-padded to 17.  The JAX state of the
    padded prefill parts from the exact-length decode by at least 0.05 of
    the logits' scale; the port, in the same padded batch beside a
    full-length row, gives the exact-length JAX logits within 2e-5."""
    jcfg, tcfg = _cfgs(6)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    L, S, s_max = 12, 17, 48
    rng = np.random.default_rng(L)
    prompt = rng.integers(0, jcfg.vocab_size, (1, L)).astype(np.int32)
    padded = np.zeros((1, S), np.int32)
    padded[:, :L] = prompt
    jl, jc = jax_prefill(jp, {"tokens": jnp.asarray(prompt)}, jcfg,
                         policy=J32)
    tok = np.asarray(jnp.argmax(jl[:, 0], -1))[:, None].astype(np.int32)
    exact, _ = jax_decode(jp, jnp.asarray(tok),
                          pad_prefill_caches(jc, jcfg, s_max),
                          jnp.asarray([L], jnp.int32), jcfg, policy=J32)
    _, jpc = jax_prefill(jp, {"tokens": jnp.asarray(padded)}, jcfg,
                         policy=J32)
    fault, _ = jax_decode(jp, jnp.asarray(tok),
                          pad_prefill_caches(jpc, jcfg, s_max),
                          jnp.asarray([L], jnp.int32), jcfg, policy=J32)
    print(f"JAX padded-row decode logits: {_rel(fault, exact):.3g} of scale "
          f"from the exact-length decode")
    assert _rel(fault, exact) >= 0.05
    other = rng.integers(0, jcfg.vocab_size, (1, S)).astype(np.int32)
    batch = torch.from_numpy(np.concatenate([padded, other]))
    _, tc = prefill(tp, {"tokens": batch}, tcfg, policy=T32,
                    true_lens=torch.tensor([L, S]))
    tc = _to_decode(tcfg, tc, 2, s_max, torch.float32)
    toks = torch.from_numpy(np.array([[tok[0, 0]], [0]], np.int32))
    got, _ = decode_step(tp, toks, tc, np.array([L, S], np.int32), tcfg,
                         policy=T32)
    assert _rel(got[:1].numpy(), exact) <= F32_TOL


def test_port_engine_mixed_lengths_match_each_row_alone():
    """The engine twin of the fault (smoke config, W = 16): prompts of 20,
    40 and 9 tokens prefilled together (one batch padded to 40) give the
    greedy tokens each prompt gives served alone."""
    jcfg, tcfg = _cfgs(6)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 256, size=(n,)).astype(np.int32)
               for n in (20, 40, 9)]

    def serve(idx):
        reqs = [tcore.Request(request_id=i, arrival_time=0.0,
                              prompt_len=len(prompts[i]), max_new_tokens=12,
                              prompt_tokens=prompts[i]) for i in idx]
        eng = ServingEngine(tcfg, tp, tcore.FCFSScheduler(), EngineConfig(
            max_slots=4, s_max=96, kv_pool_tokens=2048, buckets=(64,),
            max_prefill_tokens=1024), device="cpu")
        eng.run(reqs, max_steps=2000)
        assert eng.prefill_batches == 1
        return eng.output_tokens

    together = serve([0, 1, 2])
    for i in range(len(prompts)):
        assert serve([i])[i] == together[i]


def test_profile_ranges_wrap_the_scan_and_gates(monkeypatch):
    """``launch/profile_serve.py`` wraps the RG-LRU scan and gates in
    profiler ranges that a prefill and a decode step run through, and the
    wrapped functions compute what they did."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import profile_serve
    from repro_torch.models import rglru
    for attr, _ in profile_serve._RGLRU_RANGES:
        monkeypatch.setattr(rglru, attr, getattr(rglru, attr))
    jcfg, tcfg = _cfgs(6)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (1, 20)).astype(np.int32))
    want, caches = prefill(tp, {"tokens": toks}, tcfg, policy=T32)
    profile_serve._trace_rglru()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got, _ = prefill(tp, {"tokens": toks}, tcfg, policy=T32)
        decode_step(tp, torch.zeros((1, 1), dtype=torch.int32),
                    _to_decode(tcfg, caches, 1, 40, torch.float32), 20, tcfg,
                    policy=T32)
    assert torch.equal(got, want)
    counts = {e.key: e.count for e in prof.key_averages()
              if e.key.startswith("rglru.")}
    # 4 RG-LRU layers: one scan in the prefill, gates in prefill and decode
    assert counts == {"rglru.scan": 4, "rglru.gates": 8}
    assert set(profile_serve._rglru_device_us(prof)) == set(counts)
