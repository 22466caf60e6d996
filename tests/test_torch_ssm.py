"""The PyTorch port's SSM path on the CPU, against the JAX package.

The port's plain SSD kernel is held against the JAX Pallas kernel in
interpret mode, its scan against the JAX wrapper and the sequential
recurrence, and the mamba2 smoke model (JAX weights carried by ``bridge``)
against the JAX ``prefill`` / ``decode_step``.  Inputs are numpy from a
seed.  Tolerances follow ``tests/test_kernels.py:97-113``: 1e-4 relative to
the output's scale for the SSD (the chunked and sequential forms sum in
different orders), 1e-4 absolute and relative for the model in f32.

Two faults of the JAX reference are shown fixed in the port here: a prompt
longer than the chunk and not a multiple of it (the JAX ``ssd_chunked``
asserts), and right-padded rows of a mixed-length batch (the JAX prefill
folds the padding into the state and the conv tail).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels.ssd_scan.kernel import ssd_chunk_call
from repro.kernels.ssd_scan.ops import ssd as jax_ssd
from repro.models import DtypePolicy as JaxPolicy
from repro.models import decode_step as jax_decode
from repro.models import init_params as jax_init
from repro.models import prefill as jax_prefill
from repro.models.ssm import ssm_forward as jax_ssm_forward
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import (ssd_chunk_ref,
                                              ssd_chunk_tiled_ref, ssd_ref)
from repro_torch.models import DtypePolicy, decode_step, init_params, prefill
from repro_torch.models.ssm import ssm_forward

ARCH = "mamba2-370m"
SSD_TOL = 1e-4          # relative to the output's scale
TOL = 1e-4              # model logits and caches, f32
J32 = JaxPolicy(jnp.float32, jnp.float32, jnp.float32)
T32 = DtypePolicy(torch.float32, torch.float32, torch.float32)

# (b, s, h, p, g, n, chunk): the three TestSSD shapes and a grouped case
SSD_SHAPES = [
    (2, 256, 4, 64, 1, 128, 128),
    (1, 128, 8, 64, 2, 32, 32),         # grouped B/C
    (1, 192, 2, 64, 1, 64, 64),         # non-pow2 length
    (2, 64, 8, 16, 4, 16, 32),          # grouped, mamba2 smoke widths
]
# the bf16 kernel's plain version also at H/G = 3 (a slab of 3 heads),
# N = 24 (not a multiple of 16) and a chunk that is not a multiple of 64
SSD_TILED_SHAPES = SSD_SHAPES + [(1, 200, 6, 16, 2, 24, 100)]
BF16_SSD_TOL = 3e-2     # bf16 inputs, P′ and w∘x rounded to bf16


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) / scale


def _ssd_inputs(seed, b, s, h, p, g, n):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
    A = np.log(np.linspace(1.0, 8.0, h)).astype(np.float32)
    B = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    return x, dt, A, B, C


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


class TestSSDKernelPlain:
    @pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SHAPES)
    def test_chunk_matches_pallas_interpret(self, b, s, h, p, g, n, chunk):
        """All four outputs of the plain ssd_chunk (B, C read by group)
        against the JAX kernel (B, C repeated to every head)."""
        x, dt, A, B, C = _ssd_inputs(0, b, s, h, p, g, n)
        nc, rep = s // chunk, h // g
        xc = x.reshape(b, nc, chunk, h, p)
        dtc = dt.reshape(b, nc, chunk, h)
        want = ssd_chunk_call(
            jnp.asarray(xc), jnp.asarray(dtc), jnp.asarray(A),
            jnp.asarray(np.repeat(B, rep, 2).reshape(b, nc, chunk, h, n)),
            jnp.asarray(np.repeat(C, rep, 2).reshape(b, nc, chunk, h, n)),
            interpret=True)
        got = ssd_ops.ssd_chunk(*_t(xc, dtc, A,
                                    B.reshape(b, nc, chunk, g, n),
                                    C.reshape(b, nc, chunk, g, n)))
        for name, w, o in zip(("y_diag", "states", "in_decay", "chunk_decay"),
                              want, got):
            assert tuple(o.shape) == w.shape and o.dtype == torch.float32
            assert _rel_err(o.numpy(), w) <= SSD_TOL, name

    @pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SHAPES)
    @pytest.mark.parametrize("jax_impl", ["pallas_interpret", "ref"])
    def test_ssd_matches_jax_wrapper(self, b, s, h, p, g, n, chunk, jax_impl):
        x, dt, A, B, C = _ssd_inputs(1, b, s, h, p, g, n)
        want = jax_ssd(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                       chunk=chunk, impl=jax_impl)
        y, _ = ssd_ops.ssd(*_t(x, dt, A, B, C), chunk=chunk)
        assert _rel_err(y.numpy(), want) <= SSD_TOL

    @pytest.mark.parametrize("s,chunk", [(256, 64), (200, 64), (40, 32),
                                         (20, 32)])
    def test_ssd_output_and_final_state_match_recurrence(self, s, chunk):
        """Also for s not a multiple of the chunk (padded with dt = 0) and
        s below it; the recurrence's y is the JAX oracle's."""
        x, dt, A, B, C = _ssd_inputs(2, 2, s, 4, 16, 2, 32)
        y, h = ssd_ops.ssd(*_t(x, dt, A, B, C), chunk=chunk)
        yr, hr = ssd_ref(*_t(x, dt, A, B, C))
        want = jax_ssd(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                       impl="ref")
        assert h.shape == (2, 4, 16, 32)
        assert _rel_err(yr.numpy(), want) <= SSD_TOL
        assert _rel_err(y.numpy(), yr.numpy()) <= SSD_TOL
        assert _rel_err(h.numpy(), hr.numpy()) <= SSD_TOL

    def test_h_init_carries_over(self):
        """Two halves with the first half's final state as h_init give the
        whole sequence's output and state."""
        x, dt, A, B, C = _ssd_inputs(3, 1, 96, 4, 16, 1, 16)
        args = _t(x, dt, A, B, C)
        y, h = ssd_ops.ssd(*args, chunk=32)
        y1, h1 = ssd_ops.ssd(*(a[:, :50] if a.dim() > 1 else a for a in args),
                             chunk=32)
        y2, h2 = ssd_ops.ssd(*(a[:, 50:] if a.dim() > 1 else a for a in args),
                             chunk=32, h_init=h1)
        assert _rel_err(torch.cat([y1, y2], 1).numpy(), y.numpy()) <= SSD_TOL
        assert _rel_err(h2.numpy(), h.numpy()) <= SSD_TOL

    @pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_TILED_SHAPES)
    def test_tiled_unrounded_equals_plain(self, b, s, h, p, g, n, chunk):
        """Without rounding the tiled form is the plain one, up to f32
        summation order."""
        x, dt, A, B, C = _ssd_inputs(5, b, s, h, p, g, n)
        nc = s // chunk
        args = _t(x.reshape(b, nc, chunk, h, p), dt.reshape(b, nc, chunk, h),
                  A, B.reshape(b, nc, chunk, g, n),
                  C.reshape(b, nc, chunk, g, n))
        for name, o, r in zip(("y_diag", "states", "in_decay", "chunk_decay"),
                              ssd_chunk_tiled_ref(*args, round=False),
                              ssd_chunk_ref(*args)):
            assert o.shape == r.shape and o.dtype == torch.float32
            assert _rel_err(o.numpy(), r.numpy()) <= 1e-5, name

    @pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_TILED_SHAPES)
    def test_tiled_bf16_matches_pallas_interpret(self, b, s, h, p, g, n,
                                                 chunk):
        """The kernel's bf16 arithmetic (P′ and w∘x rounded) on bf16 x, B
        and C against the JAX kernel in interpret mode on the same bf16
        values."""
        x, dt, A, B, C = _ssd_inputs(6, b, s, h, p, g, n)
        nc, rep = s // chunk, h // g
        xc = x.reshape(b, nc, chunk, h, p)
        dtc = dt.reshape(b, nc, chunk, h)
        Bc, Cc = (a.reshape(b, nc, chunk, g, n) for a in (B, C))
        bf = jnp.bfloat16
        want = ssd_chunk_call(
            jnp.asarray(xc, dtype=bf), jnp.asarray(dtc), jnp.asarray(A),
            jnp.asarray(np.repeat(Bc, rep, 3), dtype=bf),
            jnp.asarray(np.repeat(Cc, rep, 3), dtype=bf), interpret=True)
        got = ssd_chunk_tiled_ref(
            torch.from_numpy(xc).bfloat16(), torch.from_numpy(dtc),
            torch.from_numpy(A), torch.from_numpy(Bc).bfloat16(),
            torch.from_numpy(Cc).bfloat16())
        for name, w, o in zip(("y_diag", "states", "in_decay", "chunk_decay"),
                              want, got):
            assert tuple(o.shape) == w.shape and o.dtype == torch.float32
            assert _rel_err(o.numpy(), np.asarray(w, np.float32)) <= \
                BF16_SSD_TOL, name

    def test_cpu_never_launches_and_refuses_other_devices(self):
        ssd_ops.KERNEL.launches = 0
        x, dt, A, B, C = _ssd_inputs(4, 1, 64, 2, 16, 1, 16)
        ssd_ops.ssd(*_t(x, dt, A, B, C), chunk=32)
        ssd_ops.ssd(*_t(x, dt, A, B, C), chunk=32, impl="plain")
        assert ssd_ops.KERNEL.launches == 0
        with pytest.raises(ValueError):
            ssd_ops.ssd(*_t(x, dt, A, B, C), impl="pallas")
        meta = [torch.empty(a.shape, device="meta")
                for a in (x.reshape(1, 2, 32, 2, 16), dt.reshape(1, 2, 32, 2),
                          A, B.reshape(1, 2, 32, 1, 16),
                          C.reshape(1, 2, 32, 1, 16))]
        with pytest.raises(ValueError):
            ssd_ops.ssd_chunk(*meta)
        assert ssd_ops.KERNEL.launches == 0


@pytest.fixture(scope="module")
def weights():
    """(JAX config, port config, JAX params, port params) of the mamba2
    smoke config."""
    jcfg, tcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    return jcfg, tcfg, jp, tp


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _caches_close(jax_caches, port_caches, tcfg, rows=slice(None)):
    got = bridge.caches_to_numpy(port_caches, tcfg)
    la, lb = jax.tree.leaves(jax_caches), jax.tree.leaves(got)
    assert len(la) == len(lb) > 0
    for a, b in zip(la, lb):     # stacked layers: (n_layers, batch, ...)
        np.testing.assert_allclose(b[:, rows], np.asarray(a), atol=TOL,
                                   rtol=TOL)


class TestSSMModel:
    def test_config_has_published_widths(self):
        cfg = get_config(ARCH)
        assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.n_ssm_heads,
                cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups,
                cfg.conv_width, cfg.ssm_chunk, cfg.vocab_size,
                cfg.tie_embeddings) == (48, 1024, 2048, 32, 64, 128, 1, 4,
                                        256, 50280, True)

    def test_bridge_round_trips_exact(self, weights):
        jcfg, tcfg, jp, tp = weights
        assert tp.blocks[0].mlp is None and tp.blocks[0].ln2 is None
        back = bridge.params_to_numpy(tp, tcfg)
        assert jax.tree.structure(jp) == jax.tree.structure(back)
        assert all(np.array_equal(np.asarray(a), b) for a, b in
                   zip(jax.tree.leaves(jp), jax.tree.leaves(back)))
        _, jc = jax_prefill(jp, {"tokens": jnp.asarray(
            _tokens(0, (2, 12), jcfg.vocab_size))}, jcfg, policy=J32)
        tc = bridge.caches_from_jax(jax.tree.map(np.asarray, jc), tcfg,
                                    device="cpu")
        assert set(tc[0]) == {"ssm", "conv"}
        back = bridge.caches_to_numpy(tc, tcfg)
        assert jax.tree.structure(jc) == jax.tree.structure(back)
        assert all(np.array_equal(np.asarray(a), b) for a, b in
                   zip(jax.tree.leaves(jc), jax.tree.leaves(back)))

    def test_ssm_block_matches_jax(self, weights):
        jcfg, tcfg, jp, tp = weights
        rng = np.random.default_rng(5)
        x = (rng.standard_normal((2, 64, jcfg.d_model)) * 0.5).astype(
            np.float32)
        jmix = jax.tree.map(lambda a: a[0], jp["blocks"]["stack"]["slot_0"])[
            "mixer"]
        jy, jst = jax_ssm_forward(jmix, jnp.asarray(x), jcfg,
                                  return_state=True)
        ty, tst = ssm_forward(tp.blocks[0].mixer, torch.from_numpy(x), tcfg,
                              return_state=True)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL,
                                   rtol=TOL)
        for name in ("ssm", "conv"):
            np.testing.assert_allclose(tst[name].numpy(),
                                       np.asarray(jst[name]), atol=TOL,
                                       rtol=TOL)

    @pytest.mark.parametrize("S", [24, 64])
    def test_prefill_and_decode_match_jax(self, weights, S):
        jcfg, tcfg, jp, tp = weights
        toks = _tokens(6, (2, S), jcfg.vocab_size)
        jl, jc = jax_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                             policy=J32)
        tl, tc = prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                         policy=T32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        _caches_close(jc, tc, tcfg)
        pos = np.array([S, S], dtype=np.int32)
        tok = np.asarray(jnp.argmax(jl[:, 0], -1))[:, None].astype(np.int32)
        for _ in range(4):
            jl, jc = jax_decode(jp, jnp.asarray(tok), jc, jnp.asarray(pos),
                                jcfg, policy=J32)
            tl, tc = decode_step(tp, torch.from_numpy(tok), tc, pos, tcfg,
                                 policy=T32)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                       rtol=TOL)
            _caches_close(jc, tc, tcfg)
            tok = np.asarray(jnp.argmax(jl[:, 0], -1))[:, None].astype(
                np.int32)
            assert np.array_equal(tok, tl[:, 0].argmax(-1, keepdim=True)
                                  .numpy())
            pos = pos + 1

    def test_prompt_longer_than_chunk_not_a_multiple(self, weights):
        """Reference fault 1: the JAX prefill of 40 tokens (chunk 32)
        raises; the port's equals a JAX prefill of 32 tokens followed by 8
        JAX decode steps over the other 8."""
        jcfg, tcfg, jp, tp = weights
        assert jcfg.ssm_chunk == 32
        toks = _tokens(7, (2, 40), jcfg.vocab_size)
        with pytest.raises(AssertionError):
            jax_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, policy=J32)
        jl, jc = jax_prefill(jp, {"tokens": jnp.asarray(toks[:, :32])}, jcfg,
                             policy=J32)
        for t in range(32, 40):
            jl, jc = jax_decode(jp, jnp.asarray(toks[:, t:t + 1]), jc,
                                jnp.int32(t), jcfg, policy=J32)
        tl, tc = prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                         policy=T32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        _caches_close(jc, tc, tcfg)

    def test_mixed_length_batch_rows_match_each_row_alone(self, weights):
        """Reference fault 2: each right-padded row of a batch, prefilled
        with its true length, gets the logits and cache of a JAX prefill of
        that row alone, and decodes on from there as that row would."""
        jcfg, tcfg, jp, tp = weights
        lens = np.array([20, 64, 7, 32], dtype=np.int32)
        toks = _tokens(8, (4, 64), jcfg.vocab_size)
        for i, n in enumerate(lens):
            toks[i, n:] = 0                        # right padding, token 0
        tl, tc = prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                         policy=T32, true_lens=torch.from_numpy(lens))
        nxt = np.asarray([[7], [11], [13], [17]], dtype=np.int32)
        tl2, tc2 = decode_step(tp, torch.from_numpy(nxt), tc, lens, tcfg,
                               policy=T32)
        for i, n in enumerate(lens):
            jl, jc = jax_prefill(jp, {"tokens": jnp.asarray(toks[i:i + 1, :n])},
                                 jcfg, policy=J32)
            np.testing.assert_allclose(tl[i:i + 1].numpy(), np.asarray(jl),
                                       atol=TOL, rtol=TOL)
            jl2, jc2 = jax_decode(jp, jnp.asarray(nxt[i:i + 1]), jc,
                                  jnp.int32(n), jcfg, policy=J32)
            np.testing.assert_allclose(tl2[i:i + 1].numpy(), np.asarray(jl2),
                                       atol=TOL, rtol=TOL)
            _caches_close(jc2, tc2, tcfg, rows=slice(i, i + 1))

    def test_init_params_seeded_without_mlp(self):
        cfg = get_smoke_config(ARCH)
        a = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
        b = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
        assert len(a.blocks) == cfg.n_layers
        assert all(bp.mlp is None and bp.kind == "ssm" for bp in a.blocks)
        assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                     b.parameters()))
        assert a.blocks[0].mixer["A_log"].dtype == torch.float32
