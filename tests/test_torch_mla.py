"""The PyTorch port's MLA attention and the deepseek-v2-lite model on the
CPU, against the JAX package.

deepseek-v2-lite's smoke config: 3 layers (the first with a dense MLP, the
others MoE with 8 experts, top-2, one shared), d 64, 4 heads, head dim 16
+ 8 rope, latent rank 32.  Weights come from the JAX initializer and cross
through ``bridge``; the JAX ``{"latent", "k_rope"}`` cache pair crosses
into the port's one ``{"ckv"}`` tensor and back.  On CPU tensors the port
runs the plain versions of its kernels: MLA prefill and chunks through
flash attention with keys of hd + rd and values of vd (a chunk's
decompressed from the latent rows, at a query offset), absorbed decode
through paged attention over the latent rows.  The engine runs bucketed,
chunked, radix and chunked+radix against the JAX engine, and JAX-exported
latent prefix blocks import into the port.  Everything runs in f32; outputs
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
from repro.models import chunk_step as jax_chunk_step
from repro.models import decode_step as jax_decode
from repro.models import init_decode_caches as jax_init_caches
from repro.models import init_params as jax_init
from repro.models import prefill as jax_prefill
from repro.models.attention import mla_chunk_decode as jax_mla_chunk
from repro.models.attention import mla_decode as jax_mla_decode
from repro.models.attention import mla_forward as jax_mla_forward
from repro.models.model import MoECtx as JaxMoECtx
from repro.models.model import pad_prefill_caches
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.kvplane import chain_block_hashes as tcore_chain
from repro_torch.models import (DtypePolicy, chunk_step, decode_step,
                                init_decode_caches, prefill)
from repro_torch.models.attention import (mla_chunk_decode, mla_decode,
                                          mla_forward)
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


# ---- chunked prefill and radix reuse --------------------------------------

ATOL = 5e-5          # tests/test_torch_chunked.py: f32 sums in other orders
BASE = dict(max_slots=4, s_max=256, kv_pool_tokens=16384)
MODES = {"chunked": dict(chunk_prefill_tokens=24),
         "radix": dict(enable_prefix_cache=True),
         "chunked+radix": dict(chunk_prefill_tokens=32,
                               enable_prefix_cache=True)}


@pytest.mark.parametrize("pos0,C", [(0, 1), (0, 16), (17, 9), (40, 1),
                                    (64, 16)])
def test_mla_chunk_decode_matches_jax(weights, pos0, C):
    """One MLA layer over a random latent cache: the port's chunk (keys and
    values decompressed from the latent rows, flash at an offset) against
    JAX's absorbed chunk, output and the cache after the in-place write
    (rows pos0..pos0+C-1 replaced, every other row untouched)."""
    jcfg, tcfg, jp, tp = weights
    rng = np.random.default_rng(pos0 * 10 + C)
    B, s_max = 2, 96
    r, rd = jcfg.kv_lora_rank, jcfg.rope_head_dim
    x = rng.standard_normal((B, C, jcfg.d_model)).astype(np.float32)
    latent = rng.standard_normal((B, s_max, r)).astype(np.float32)
    k_rope = rng.standard_normal((B, s_max, rd)).astype(np.float32)
    jy, jc = jax_mla_chunk(_mixer(jp, 1), jnp.asarray(x),
                           {"latent": jnp.asarray(latent),
                            "k_rope": jnp.asarray(k_rope)}, pos0, jcfg)
    ckv = np.concatenate([latent, k_rope], -1)[:, :, None]
    cache = {"ckv": torch.from_numpy(ckv.copy())}
    ty, tc = mla_chunk_decode(tp.blocks[1].mixer, torch.from_numpy(x), cache,
                              pos0, tcfg)
    assert tc is cache                              # updated in place
    assert _rel(ty, jy) <= REL
    got = cache["ckv"][:, :, 0].numpy()
    assert _rel(got[..., :r], jc["latent"]) <= REL
    assert _rel(got[..., r:], jc["k_rope"]) <= REL
    untouched = np.ones(s_max, bool)
    untouched[pos0:pos0 + C] = False
    np.testing.assert_array_equal(got[:, untouched], ckv[:, untouched, 0])


def test_mla_chunk_decode_refuses_window_and_overflow(weights):
    _, tcfg, _, tp = weights
    cache = {"ckv": torch.zeros((1, 32, 1, tcfg.kv_lora_rank
                                 + tcfg.rope_head_dim))}
    x = torch.zeros((1, 4, tcfg.d_model))
    with pytest.raises(NotImplementedError):
        mla_chunk_decode(tp.blocks[1].mixer, x, cache, 0, tcfg, window=8)
    with pytest.raises(ValueError):
        mla_chunk_decode(tp.blocks[1].mixer, x, cache, 30, tcfg)


@pytest.mark.parametrize("moe_impl", ["dense", "dropping"])
def test_chunk_step_matches_jax(weights, moe_impl):
    """The whole model in chunks of 16, 16 and 9 through the port's
    chunk_step against JAX's chunk_step, MoE in either mode: each chunk's
    logits and the final caches."""
    jcfg, tcfg, jp, tp = weights
    rng = np.random.default_rng(5)
    toks = rng.integers(0, tcfg.vocab_size, size=(1, 41)).astype(np.int32)
    jc = jax_init_caches(jcfg, 1, 64, dtype=np.float32)
    tc = init_decode_caches(tcfg, 1, 64, dtype=torch.float32, device="cpu")
    pos = 0
    for width in (16, 16, 9):
        chunk = toks[:, pos:pos + width]
        jl, jc = jax_chunk_step(jp, jnp.asarray(chunk), jc, np.int32(pos),
                                jcfg, JaxMoECtx(impl=moe_impl), policy=J32)
        tl, _ = chunk_step(tp, torch.from_numpy(chunk), tc, pos, tcfg,
                           policy=T32, moe_impl=moe_impl)
        assert _rel(tl, jl) <= REL
        pos += width
    for a, b in zip(jax.tree.leaves(jc),
                    jax.tree.leaves(bridge.caches_to_numpy(tc, tcfg))):
        np.testing.assert_allclose(b, np.asarray(a), atol=ATOL, rtol=ATOL)


def test_chunk_step_equals_one_prefill_under_dense(weights):
    """Under ``dense`` the MoE layers see each token alone, so chunks of
    16, 16 and 9 give one prefill's last logits and latent rows; under
    ``dropping`` a chunk's capacity differs from the whole prompt's
    (``ROADMAP.md`` §3, the copied reference fault)."""
    _, tcfg, _, tp = weights
    rng = np.random.default_rng(6)
    toks = rng.integers(0, tcfg.vocab_size, size=(1, 41)).astype(np.int32)
    tc = init_decode_caches(tcfg, 1, 64, dtype=torch.float32, device="cpu")
    pos = 0
    for width in (16, 16, 9):
        tl, _ = chunk_step(tp, torch.from_numpy(toks[:, pos:pos + width]), tc,
                           pos, tcfg, policy=T32, moe_impl="dense")
        pos += width
    ref_logits, ref_caches = prefill(tp, {"tokens": torch.from_numpy(toks)},
                                     tcfg, policy=T32, moe_impl="dense")
    np.testing.assert_allclose(tl.numpy(), ref_logits.numpy(), atol=ATOL)
    for layer, ref in zip(tc, ref_caches):
        np.testing.assert_allclose(layer["ckv"][:, :41].numpy(),
                                   ref["ckv"].numpy(), atol=ATOL)
        assert not layer["ckv"][:, 41:].any()


def _prefix_requests(pkg, n=6, seed=0, base=0, prefix=None, max_new=6,
                     vocab=256):
    """tests/test_torch_chunked.py's requests: 40-99-token prompts, the
    first up to 48 tokens of each the shared ``prefix``."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(seed * 1000 + i)
        pl = int(rng.integers(40, 100))
        toks = rng.integers(0, vocab, size=(pl,)).astype(np.int32)
        if prefix is not None:
            toks[:min(len(prefix), pl - 8)] = prefix[:min(len(prefix), pl - 8)]
        out.append(pkg.Request(request_id=base + i, arrival_time=0.0,
                               prompt_len=pl, max_new_tokens=max_new,
                               prompt_tokens=toks))
    return out


def _prefix(vocab=256):
    return np.random.default_rng(7).integers(0, vocab, size=(48,)).astype(
        np.int32)


def _two_waves(pkg):
    pfx = _prefix()
    return (_prefix_requests(pkg, seed=3, prefix=pfx)
            + _prefix_requests(pkg, seed=6, prefix=pfx, base=10))


def _run(weights, ecfg: dict, reqs, *, jax_side: bool = False):
    jcfg, tcfg, jp, tp = weights
    if jax_side:
        eng = JaxEngine(jcfg, jp, jcore.FCFSScheduler(),
                        JaxEngineConfig(**ecfg))
    else:
        eng = ServingEngine(tcfg, tp, tcore.FCFSScheduler(),
                            EngineConfig(**ecfg), device="cpu")
    eng.run(reqs, max_steps=4000)
    return eng


def _pool_allocs(eng):
    """Pool allocations with the radix's object id taken out of its keys."""
    return {(k[0], k[2]) if isinstance(k, tuple) else k: v
            for k, v in eng.pool.allocs.items()}


@pytest.fixture(scope="module", params=list(MODES))
def mla_engine_pair(request, weights):
    """The JAX and the port engine over two waves of 6 requests sharing a
    48-token prefix, in one mode, MoE in the engines' default
    ``dropping``."""
    ecfg = {**BASE, **MODES[request.param]}
    return (request.param,
            _run(weights, ecfg, _two_waves(jcore), jax_side=True),
            _run(weights, ecfg, _two_waves(tcore)))


def test_chunked_and_prefix_modes_match_jax_for_mla(mla_engine_pair):
    """deepseek's smoke config in chunked, radix and chunked+radix mode:
    greedy tokens, dispatch order, pool allocations, cached_len per
    request, prefix-saved tokens, radix stats and chunk counts equal the
    JAX engine's, and the radix copies count MLA's latent rows."""
    mode, jeng, teng = mla_engine_pair
    assert teng.e.moe_impl == jeng.e.moe_impl == "dropping"
    assert len(teng.finished) == len(jeng.finished) == 12
    assert teng.output_tokens == jeng.output_tokens
    assert all(len(v) == 6 for v in teng.output_tokens.values())
    assert [rid for _, rid in teng.dispatch_log] == \
        [rid for _, rid in jeng.dispatch_log]
    assert _pool_allocs(teng) == _pool_allocs(jeng)
    assert teng.pool.free_blocks == jeng.pool.free_blocks
    assert {r.request_id: r.cached_len for r in teng.finished} == \
        {r.request_id: r.cached_len for r in jeng.finished}
    js, ts = jeng.stats(), teng.stats()
    for key in ("prefix_saved_tokens", "radix", "chunks", "chunk_tokens",
                "preemptions", "padding_waste"):
        assert ts[key] == js[key], key
    if "radix" in mode:
        assert ts["prefix_saved_tokens"] > 0
        teng.radix.check_invariants()
        assert sorted(teng._node_kv) == sorted(jeng._node_kv)
        cfg = teng.cfg
        row = cfg.n_layers * (cfg.kv_lora_rank + cfg.rope_head_dim) * 4
        assert teng._block_bytes() == 16 * row
        copies = ts["radix_copies"]
        assert copies["h2d_bytes"] == copies["h2d_blocks"] * 16 * row
        assert copies["h2d_blocks"] * 16 == ts["prefix_saved_tokens"]
    else:
        assert ts["chunks"] > len(teng.finished)


def test_mla_engine_caches_match_jax(mla_engine_pair):
    """The slot caches after the run hold the JAX engine's latent and rope
    rows, within the chunked tests' f32 tolerance."""
    _, jeng, teng = mla_engine_pair
    got = bridge.caches_to_numpy(teng.caches, teng.cfg)
    for a, b in zip(jax.tree.leaves(jeng.caches), jax.tree.leaves(got)):
        np.testing.assert_allclose(b, np.asarray(a), atol=ATOL, rtol=ATOL)


def test_mla_chunked_equals_bucketed_under_dense(weights):
    """Under ``dense`` MoE the bucketed path and chunked+radix prefill
    give the same greedy tokens on two waves sharing a prefix; the
    chunked run really chunks and attaches."""
    dense = {**BASE, "moe_impl": "dense"}
    e_leg = _run(weights, dense, _two_waves(tcore))
    e_chk = _run(weights, {**dense, **MODES["chunked+radix"]},
                 _two_waves(tcore))
    assert e_leg.output_tokens == e_chk.output_tokens
    assert e_chk.stats()["chunks"] > len(e_chk.finished)
    assert e_chk.prefix_saved_tokens > 0


def test_jax_exported_mla_prefix_imports_into_the_port(weights):
    """MLA prefix blocks exported by a JAX engine (``{"latent",
    "k_rope"}``), joined by the bridge into ``{"ckv"}`` rows and imported by
    a port engine, export back bit-exact and give that engine the
    recompute's greedy tokens, the prefix attached rather than
    recomputed.  MoE runs ``dense``: under ``dropping`` a suffix prefilled
    alone gets another capacity than the whole prompt (``ROADMAP.md`` §3),
    so attach and recompute part in both packages."""
    jcfg, tcfg, _, tp = weights
    pfx = _prefix()
    ecfg = {**BASE, "enable_prefix_cache": True, "moe_impl": "dense"}
    jeng = _run(weights, ecfg, _prefix_requests(jcore, n=2, seed=3,
                                                prefix=pfx), jax_side=True)
    wave = _prefix_requests(tcore, seed=8, prefix=pfx, base=20)
    hashes = tcore_chain(wave[0].prompt_tokens.tolist(), 16)
    blocks = jeng.export_prefix_blocks(hashes, want=len(hashes))
    assert 0 < len(blocks) <= 3                   # within the 48-token prefix
    teng = ServingEngine(tcfg, tp, tcore.FCFSScheduler(),
                         EngineConfig(**ecfg), device="cpu")
    port_blocks = [bridge.caches_from_jax(b, tcfg, device="cpu")
                   for b in blocks]
    r, rd = tcfg.kv_lora_rank, tcfg.rope_head_dim
    assert [tuple(c["ckv"].shape) for c in port_blocks[0]] == \
        [(16, 1, r + rd)] * tcfg.n_layers
    landed = teng.import_prefix_blocks(hashes, port_blocks)
    assert landed == len(blocks)
    for i, block in enumerate(blocks):
        back = bridge.caches_to_numpy(
            teng.export_prefix_blocks(hashes, landed)[i], tcfg)
        assert _leaves_equal(block, back)
    teng.run(wave, max_steps=4000)
    assert all(r.cached_len > 0 for r in teng.finished)
    assert teng.stats()["radix_copies"]["h2d_blocks"] > 0
    recompute = _run(weights, {**BASE, "chunk_prefill_tokens": 1024,
                               "moe_impl": "dense"},
                     _prefix_requests(tcore, seed=8, prefix=pfx, base=20))
    assert teng.output_tokens == recompute.output_tokens
    teng.radix.check_invariants()
