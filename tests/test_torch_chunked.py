"""The port's chunked prefill and engine-side radix prefix reuse on the CPU,
against the JAX package.

Every input is made from a seed with numpy and handed to both sides; weights
are the llama2-13b smoke config's, JAX-initialized and bridged to the port.
On CPU tensors the flash wrapper runs its plain version, so these tests hold
the arithmetic around the CUDA kernel (query offset, visible-key count, the
in-place cache writes) and the engine's control flow.

f32 tolerance is atol 5e-5, as ``tests/test_engine_equivalence.py`` holds
JAX's chunk_step against its prefill: both sides compute the same f32
softmax attention and matmuls, but sum in other orders (a masked dense
softmax over the whole cache against keys cut to the visible ones), so
logits and cache entries of order 1 differ in the last few f32 ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.configs import get_smoke_config as jax_smoke
from repro.kvplane.radix import RadixPrefixIndex as JaxRadix
from repro.kvplane.radix import chain_block_hashes as jax_chain
from repro.models import DtypePolicy as JaxPolicy
from repro.models import chunk_step as jax_chunk_step
from repro.models import init_decode_caches as jax_init_caches
from repro.models import init_params as jax_init
from repro.models.attention import gqa_attend
from repro.models.attention import gqa_chunk_decode as jax_gqa_chunk
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxEngine
from repro.serving.kv_cache import BlockPool as JaxPool
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                     flash_attention_tiled_ref)
from repro_torch.kvplane import RadixPrefixIndex, chain_block_hashes
from repro_torch.models import (DtypePolicy, chunk_step, init_decode_caches,
                                prefill, supports_chunked_decode)
from repro_torch.models.attention import gqa_chunk_decode
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.kv_cache import BlockPool

ARCH = "llama2-13b"
ATOL = 5e-5
F32 = DtypePolicy(torch.float32, torch.float32, torch.float32)
JF32 = JaxPolicy(jnp.float32, jnp.float32, jnp.float32)
BASE = dict(max_slots=4, s_max=256, kv_pool_tokens=16384)


@pytest.fixture(scope="module")
def weights():
    """(JAX config, port config, JAX params, port params)."""
    jcfg, tcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    return jcfg, tcfg, jp, tp


# ---- the flash wrapper's query offset and visible-key count -----------------

@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("C", [1, 9, 16])
@pytest.mark.parametrize("pos0", [0, 17, 64])
def test_flash_offset_matches_jax_chunk_attention(pos0, C, window):
    """C queries at pos0.. against a whole (B, T, K, hd) cache: the plain
    versions with ``q_offset=pos0, kv_len=pos0+C`` give the attention inside
    JAX's gqa_chunk_decode (a dense mask over all T positions).  Cache rows
    past pos0+C hold other values, which must never be read."""
    rng = np.random.default_rng(pos0 * 100 + C + window)
    B, T, H, K, hd = 2, 128, 4, 2, 16
    q = rng.standard_normal((B, C, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, K, hd)).astype(np.float32)
            for _ in range(2))
    positions = pos0 + np.arange(C)
    k_pos = np.arange(T)[None, :]
    mask = k_pos <= positions[:, None]
    if window:
        mask &= k_pos > positions[:, None] - window
    want = np.asarray(gqa_attend(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(mask)))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    got = flash_ops.flash_attention(qt, kt, vt, window=window, q_offset=pos0,
                                    kv_len=pos0 + C)
    np.testing.assert_allclose(got.reshape(B, C, H * hd).numpy(), want,
                               atol=ATOL, rtol=ATOL)
    tiled = flash_attention_tiled_ref(
        *(t.transpose(1, 2) for t in (qt, kt, vt)), window=window,
        q_offset=pos0, kv_len=pos0 + C, round_p=False).transpose(1, 2)
    np.testing.assert_allclose(tiled.reshape(B, C, H * hd).numpy(), want,
                               atol=ATOL, rtol=ATOL)
    assert flash_ops.KERNEL.launches == 0
    assert flash_ops.KERNEL.offset_launches == 0


def test_flash_offset_rejects_bad_arguments():
    q = torch.zeros((1, 4, 2, 16))
    k = torch.zeros((1, 8, 2, 16))
    for kw in (dict(kv_len=9), dict(kv_len=-1), dict(q_offset=-1)):
        with pytest.raises(ValueError):
            flash_ops.flash_attention(q, k, k, **kw)
    with pytest.raises(ValueError):
        flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            k.transpose(1, 2), kv_len=9)


# ---- gqa_chunk_decode and chunk_step ------------------------------------------

@pytest.mark.parametrize("C", [1, 9, 16])
@pytest.mark.parametrize("pos0", [0, 17, 64])
def test_gqa_chunk_decode_matches_jax(weights, pos0, C):
    """One attention layer: output and the cache after the in-place write
    (rows at pos0..pos0+C-1 replaced, every other row untouched)."""
    jcfg, tcfg, jp, tp = weights
    rng = np.random.default_rng(pos0 + 7 * C)
    x = rng.standard_normal((1, C, tcfg.d_model)).astype(np.float32)
    shape = (1, 128, tcfg.n_kv_heads, tcfg.head_dim)
    kc, vc = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    jparams = jax.tree.map(lambda a: a[0], jp["blocks"]["stack"]["slot_0"])
    jy, jcache = jax_gqa_chunk(jparams["mixer"], jnp.asarray(x),
                               {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
                               pos0, jcfg)
    cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    ty, tcache = gqa_chunk_decode(tp.blocks[0].mixer, torch.from_numpy(x),
                                  cache, pos0, tcfg)
    assert tcache is cache                     # updated in place
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                               rtol=ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), atol=ATOL,
                                   rtol=ATOL)
    untouched = np.ones(128, bool)
    untouched[pos0:pos0 + C] = False
    np.testing.assert_array_equal(cache["k"].numpy()[:, untouched],
                                  kc[:, untouched])


def test_gqa_chunk_decode_refuses_window_and_overflow(weights):
    _, tcfg, _, tp = weights
    cache = {"k": torch.zeros((1, 32, tcfg.n_kv_heads, tcfg.head_dim)),
             "v": torch.zeros((1, 32, tcfg.n_kv_heads, tcfg.head_dim))}
    x = torch.zeros((1, 4, tcfg.d_model))
    with pytest.raises(NotImplementedError):
        gqa_chunk_decode(tp.blocks[0].mixer, x, cache, 0, tcfg, window=8)
    with pytest.raises(ValueError):
        gqa_chunk_decode(tp.blocks[0].mixer, x, cache, 30, tcfg)


def test_chunk_step_matches_jax_and_one_prefill(weights):
    """Chunks of 16, 16, 16 and 9 through the port's chunk_step: each
    chunk's logits and the final caches equal JAX's chunk_step, and the
    last logits and the resident K/V equal one prefill of all 57 tokens."""
    jcfg, tcfg, jp, tp = weights
    assert supports_chunked_decode(tcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tcfg.vocab_size, size=(1, 57)).astype(np.int32)
    jc = jax_init_caches(jcfg, 1, 128, dtype=np.float32)
    tc = init_decode_caches(tcfg, 1, 128, dtype=torch.float32, device="cpu")
    pos = 0
    for width in (16, 16, 16, 9):
        chunk = toks[:, pos:pos + width]
        jl, jc = jax_chunk_step(jp, chunk, jc, np.int32(pos), jcfg,
                                policy=JF32)
        tl, tc2 = chunk_step(tp, torch.from_numpy(chunk), tc, pos, tcfg,
                             policy=F32)
        assert tc2 is tc
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        pos += width
    got = bridge.caches_to_numpy(tc, tcfg)
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(got)):
        np.testing.assert_allclose(b, np.asarray(a), atol=ATOL)
    ref_logits, ref_caches = prefill(tp, {"tokens": torch.from_numpy(toks)},
                                     tcfg, policy=F32)
    np.testing.assert_allclose(tl.numpy(), ref_logits.numpy(), atol=ATOL)
    for layer, ref in zip(tc, ref_caches):
        for name in ("k", "v"):
            np.testing.assert_allclose(layer[name][:, :57].numpy(),
                                       ref[name].numpy(), atol=ATOL)
            assert not layer[name][:, 57:].any()


# ---- the radix index copy ----------------------------------------------------

def test_radix_index_matches_jax_over_a_seeded_sequence():
    """One seeded sequence of insert, match, pin, unpin and evict calls on
    both copies, each over its own package's BlockPool: every result, the
    stats, the pool and the tree agree after each call."""
    rng = np.random.default_rng(11)
    bases = [rng.integers(0, 50, size=(int(rng.integers(16, 97)),))
             for _ in range(4)]
    jpool, tpool = JaxPool(40, 16), BlockPool(40, 16)
    jr, tr = JaxRadix(jpool, 16, capacity_blocks=24), \
        RadixPrefixIndex(tpool, 16, capacity_blocks=24)
    jevicted, tevicted = [], []
    jr.on_evict, tr.on_evict = jevicted.append, tevicted.append
    pinned = []

    def depth(node):
        return None if node is None else (node.node_id, node.depth)

    for step in range(300):
        toks = np.concatenate([bases[rng.integers(0, 4)],
                               rng.integers(0, 50, size=(int(rng.integers(0, 64)),))])
        jh, th = jax_chain(toks.tolist(), 16), chain_block_hashes(toks.tolist(), 16)
        assert jh == th
        op = rng.choice(["insert", "match", "probe", "pin", "unpin", "evict"])
        now = float(step)
        if op == "insert":
            (jn, jnew), (tn, tnew) = jr.insert(jh, now), tr.insert(th, now)
            assert (depth(jn), jnew) == (depth(tn), tnew)
        elif op in ("match", "probe"):
            touch = op == "match"
            jm, tm = jr.match(jh, now, touch), tr.match(th, now, touch)
            assert (depth(jm.node), jm.blocks) == (depth(tm.node), tm.blocks)
            if op == "match" and jm.node is not None and rng.random() < 0.5:
                jr.pin(jm.node)
                tr.pin(tm.node)
                pinned.append((jm.node, tm.node))
        elif op == "unpin" and pinned:
            jn, tn = pinned.pop(int(rng.integers(0, len(pinned))))
            jr.unpin(jn)
            tr.unpin(tn)
        elif op == "evict":
            n = int(rng.integers(1, 4))
            assert jr.evict(n) == tr.evict(n)
        assert jr.stats() == tr.stats()
        assert jpool.free_blocks == tpool.free_blocks
        assert jevicted == tevicted
        assert sorted(jr._leaves) == sorted(tr._leaves)
        tr.check_invariants()
    assert jr.evicted > 0 and jr.inserted > 0 and jr.hits > 0


# ---- the engine: chunked and radix modes ----------------------------------------

def _requests(pkg, n=6, seed=0, vocab=256, max_new=6, lo=40, hi=100, base=0,
              prefix=None):
    """The requests of tests/test_engine_equivalence.py, in ``pkg``."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(seed * 1000 + i)
        pl = int(rng.integers(lo, hi))
        toks = rng.integers(0, vocab, size=(pl,)).astype(np.int32)
        if prefix is not None:
            toks[:min(len(prefix), pl - 8)] = prefix[:min(len(prefix), pl - 8)]
        out.append(pkg.Request(request_id=base + i, arrival_time=0.0,
                               prompt_len=pl, max_new_tokens=max_new,
                               prompt_tokens=toks))
    return out


def _run(weights, ecfg: dict, reqs, *, jax_side: bool = False):
    jcfg, tcfg, jp, tp = weights
    if jax_side:
        eng = JaxEngine(jcfg, jp, jcore.FCFSScheduler(), JaxEngineConfig(**ecfg))
    else:
        eng = ServingEngine(tcfg, tp, tcore.FCFSScheduler(),
                            EngineConfig(**ecfg), device="cpu")
    eng.run(reqs, max_steps=4000)
    return eng


def _prefix(vocab=256):
    return np.random.default_rng(7).integers(0, vocab, size=(48,)).astype(
        np.int32)


def test_chunked_outputs_equal_bucketed(weights):
    """Greedy outputs are the same in the bucketed path and in chunked
    prefill, which really chunks."""
    e_leg = _run(weights, BASE, _requests(tcore, seed=1))
    e_chk = _run(weights, {**BASE, "chunk_prefill_tokens": 24},
                 _requests(tcore, seed=1))
    assert e_leg.output_tokens == e_chk.output_tokens
    assert e_chk.stats()["chunks"] > len(e_chk.finished)
    assert not e_chk._prefilling and e_chk.pool.allocs == {}


def test_chunked_interleaves_decode(weights):
    """A long prompt behind short ones: decode ticks run while its chunks
    are in flight."""
    reqs = _requests(tcore, n=3, seed=2, lo=16, hi=32, max_new=24)
    reqs.append(tcore.Request(request_id=99, arrival_time=0.0, prompt_len=200,
                              max_new_tokens=4,
                              prompt_tokens=np.arange(200, dtype=np.int32) % 256))
    e = _run(weights, {**BASE, "chunk_prefill_tokens": 16}, reqs)
    assert len(e.finished) == 4
    assert e.interleaved_ticks > 0
    assert e.stats()["interleaved_ticks"] == e.interleaved_ticks


def test_radix_two_wave_reuse(weights):
    """The second wave attaches cached KV (cached_len at block granularity)
    and gives the radix-off greedy outputs."""
    pfx = _prefix()
    e = _run(weights, {**BASE, "enable_prefix_cache": True},
             _requests(tcore, seed=3, prefix=pfx)
             + _requests(tcore, seed=3, prefix=pfx, base=10))
    wave2 = [r for r in e.finished if r.request_id >= 10]
    assert len(wave2) == 6
    assert all(r.cached_len > 0 and r.cached_len % 16 == 0 for r in wave2)
    assert e.prefix_saved_tokens > 0
    copies = e.stats()["radix_copies"]
    assert copies["h2d_blocks"] * 16 == e.prefix_saved_tokens
    assert copies["d2h_blocks"] == e.radix.cached_blocks
    e.radix.check_invariants()
    e_off = _run(weights, {**BASE, "chunk_prefill_tokens": 1024},
                 _requests(tcore, seed=3, prefix=pfx, base=10))
    for r in wave2:
        assert e.output_tokens[r.request_id] == e_off.output_tokens[r.request_id]


@pytest.mark.parametrize("radix", [True, False])
def test_preemption_leaks_nothing(weights, radix):
    """Preemption and re-admission under KV pressure leak no pool block and
    strand no radix pin: only radix tenancy remains after the run."""
    ecfg = dict(max_slots=4, s_max=256, kv_pool_tokens=256)
    if radix:
        ecfg.update(enable_prefix_cache=True, prefix_cache_blocks=8)
        reqs = _requests(tcore, n=6, seed=4, lo=60, hi=100, max_new=24)
    else:
        ecfg.update(chunk_prefill_tokens=32)
        reqs = _requests(tcore, n=6, seed=5, lo=60, hi=100, max_new=10)
    e = _run(weights, ecfg, reqs)
    assert len(e.finished) == 6
    assert e.preemptions > 0
    assert {k: v for k, v in e.pool.allocs.items()
            if not isinstance(k, tuple)} == {}
    if radix:
        e.radix.check_invariants()
        assert all(node.pins == 0 for node in e.radix._nodes.values())
        assert set(e._node_kv) <= set(e.radix._nodes)
    else:
        assert e.pool.free_blocks == e.pool.total_blocks


def _pool_allocs(eng):
    """Pool allocations with the radix's object id taken out of its keys."""
    return {(k[0], k[2]) if isinstance(k, tuple) else k: v
            for k, v in eng.pool.allocs.items()}


MODES = {"chunked": dict(chunk_prefill_tokens=24),
         "radix": dict(enable_prefix_cache=True),
         "chunked+radix": dict(chunk_prefill_tokens=32,
                               enable_prefix_cache=True)}


@pytest.fixture(scope="module", params=list(MODES))
def engine_pair(request, weights):
    """The JAX and the port engine over the same two waves of requests
    with a shared prefix, in one mode."""
    ecfg = {**BASE, **MODES[request.param]}
    pfx = _prefix()

    def reqs(pkg):
        return (_requests(pkg, seed=3, prefix=pfx)
                + _requests(pkg, seed=6, prefix=pfx, base=10))
    return (request.param, _run(weights, ecfg, reqs(jcore), jax_side=True),
            _run(weights, ecfg, reqs(tcore)))


def test_engine_modes_match_jax(engine_pair):
    """Greedy tokens, dispatch order, pool allocations, cached_len per
    request, prefix-saved tokens, radix stats and chunk counts agree."""
    mode, jeng, teng = engine_pair
    assert len(teng.finished) == len(jeng.finished) == 12
    assert teng.output_tokens == jeng.output_tokens
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


def test_engine_caches_match_jax(engine_pair):
    """The slot caches after the run hold what the JAX engine's hold, in
    every row a prefill or decode step wrote (chunk writes in place)."""
    _, jeng, teng = engine_pair
    got = bridge.caches_to_numpy(teng.caches, get_smoke_config(ARCH))
    for a, b in zip(jax.tree.leaves(jeng.caches), jax.tree.leaves(got)):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-4, rtol=1e-4)


def test_jax_exported_prefix_imports_into_the_port(weights):
    """Prefix blocks exported by a JAX engine, converted by the bridge and
    imported by a port engine, give that engine the recompute's greedy
    tokens, with the prefix attached rather than recomputed."""
    jcfg, tcfg, _, _ = weights
    pfx = _prefix()
    ecfg = {**BASE, "enable_prefix_cache": True}
    jeng = _run(weights, ecfg, _requests(jcore, n=2, seed=3, prefix=pfx),
                jax_side=True)
    wave = _requests(tcore, seed=8, prefix=pfx, base=20)
    hashes = chain_block_hashes(wave[0].prompt_tokens.tolist(), 16)
    blocks = jeng.export_prefix_blocks(hashes, want=len(hashes))
    assert 0 < len(blocks) <= 3                   # within the 48-token prefix
    teng = ServingEngine(tcfg, weights[3], tcore.FCFSScheduler(),
                         EngineConfig(**ecfg), device="cpu")
    landed = teng.import_prefix_blocks(
        hashes, [bridge.caches_from_jax(b, tcfg, device="cpu") for b in blocks])
    assert landed == len(blocks)
    back = bridge.caches_to_numpy(teng.export_prefix_blocks(hashes, 3)[0], tcfg)
    for a, b in zip(jax.tree.leaves(blocks[0]), jax.tree.leaves(back)):
        np.testing.assert_array_equal(b, a)
    teng.run(wave, max_steps=4000)
    assert all(r.cached_len > 0 for r in teng.finished)
    assert teng.stats()["radix_copies"]["h2d_blocks"] > 0
    recompute = _run(weights, {**BASE, "chunk_prefill_tokens": 1024},
                     _requests(tcore, seed=8, prefix=pfx, base=20))
    assert teng.output_tokens == recompute.output_tokens
    teng.radix.check_invariants()


# ---- the over-long prompt fault ------------------------------------------------

def _oversize(pkg):
    return [pkg.Request(request_id=0, arrival_time=0.0, prompt_len=20,
                        max_new_tokens=3,
                        prompt_tokens=np.arange(20, dtype=np.int32)),
            pkg.Request(request_id=1, arrival_time=0.0, prompt_len=100,
                        max_new_tokens=3,
                        prompt_tokens=np.arange(100, dtype=np.int32) % 256)]


SMALL = dict(max_slots=4, s_max=64, kv_pool_tokens=2048, buckets=(32, 64))


def test_jax_engine_loses_an_oversized_prompt(weights):
    """The reference fault: the JAX engine pops a 100-token prompt at
    s_max=64 from the queue and drops it: it is neither finished nor shed,
    still WAITING with no terminal state, so ``run`` can only stop at
    ``max_steps``."""
    reqs = _oversize(jcore)
    jeng = _run(weights, SMALL, reqs, jax_side=True)
    assert [r.request_id for r in jeng.finished] == [0] and jeng.shed == []
    assert jeng.sched.waiting() == 0
    assert reqs[1].state == jcore.RequestState.WAITING
    assert reqs[1].terminal is None


@pytest.mark.parametrize("chunk", [None, 16])
def test_port_sheds_an_oversized_prompt(weights, chunk):
    """The port sheds it with TerminalState.SHED, in the bucketed and the
    chunked mode, and ``run`` returns as soon as both requests are
    accounted for."""
    _, tcfg, _, tp = weights
    eng = ServingEngine(tcfg, tp, tcore.FCFSScheduler(),
                        EngineConfig(**SMALL, chunk_prefill_tokens=chunk),
                        device="cpu")
    reqs = _oversize(tcore)
    loops = []
    admit = eng._admit
    eng._admit = lambda now: (loops.append(now), admit(now))
    fin = eng.run(reqs)                     # default max_steps = 100_000
    assert [r.request_id for r in fin] == [0]
    assert [r.request_id for r in eng.shed] == [1]
    assert reqs[1].terminal == tcore.TerminalState.SHED
    assert reqs[1].state == tcore.RequestState.FAILED
    assert eng.stats()["terminal"] == {"finished": 1, "shed": 1}
    assert len(loops) < 50
