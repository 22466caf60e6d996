"""The PyTorch port's SSM path on the CPU, against the JAX package.

The port's plain SSD kernel is held against the JAX Pallas kernel in
interpret mode, its scan against the JAX wrapper and the sequential
recurrence, and the mamba2 smoke model (JAX weights carried by ``bridge``)
against the JAX ``prefill`` / ``decode_step``.  Inputs are numpy from a
seed.  Tolerances follow ``tests/test_kernels.py:97-113``: 1e-4 relative to
the output's scale for the SSD (the chunked and sequential forms sum in
different orders), 1e-4 absolute and relative for the model in f32.

The training scan ``models/ssm.py::ssd_chunked`` (torch ops, no kernel
wrapper) is held against the JAX ``ssd_chunked``, forward and every input's
gradient, and at a ragged S against autograd through the sequential
recurrence.

Two faults of the JAX reference are shown fixed in the port here: a prompt
longer than the chunk and not a multiple of it (the JAX ``ssd_chunked``
asserts, in prefill and in training), and right-padded rows of a
mixed-length batch (the JAX prefill folds the padding into the state and
the conv tail).
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
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro.models.ssm import ssm_forward as jax_ssm_forward
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import (ssd_chunk_ref,
                                              ssd_chunk_tiled_ref, ssd_ref)
from repro_torch.models import DtypePolicy, decode_step, init_params, prefill
from repro_torch.models.ssm import ssd_chunked, ssm_forward

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

    @pytest.mark.parametrize("tf32_products", [3, 1])
    @pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_TILED_SHAPES)
    def test_tiled_tf32x3_matches_pallas_interpret(self, b, s, h, p, g, n,
                                                   chunk, tf32_products):
        """The f32 kernels' arithmetic (every product as three TF32
        products of split operands, decays from an f64 scan) against the
        JAX kernel in interpret mode on the same f32 values: within SSD_TOL
        of scale, where one TF32 product a multiply is not, which is why
        the kernels take three."""
        x, dt, A, B, C = _ssd_inputs(7, b, s, h, p, g, n)
        nc, rep = s // chunk, h // g
        xc = x.reshape(b, nc, chunk, h, p)
        dtc = dt.reshape(b, nc, chunk, h)
        Bc, Cc = (a.reshape(b, nc, chunk, g, n) for a in (B, C))
        want = ssd_chunk_call(
            jnp.asarray(xc), jnp.asarray(dtc), jnp.asarray(A),
            jnp.asarray(np.repeat(Bc, rep, 3)),
            jnp.asarray(np.repeat(Cc, rep, 3)), interpret=True)
        got = ssd_chunk_tiled_ref(*_t(xc, dtc, A, Bc, Cc), round=False,
                                  tf32_products=tf32_products)
        errs = {}
        for name, w, o in zip(("y_diag", "states", "in_decay", "chunk_decay"),
                              want, got):
            assert tuple(o.shape) == w.shape and o.dtype == torch.float32
            errs[name] = _rel_err(o.numpy(), w)
        print(f"{tf32_products} TF32 product(s) a multiply, {(b, s, h, p, g, n, chunk)}: "
              f"error relative to scale {errs}")
        if tf32_products == 3:
            assert max(errs.values()) <= SSD_TOL, errs
        else:
            assert max(errs["y_diag"], errs["states"]) > SSD_TOL, (
                f"one TF32 product held SSD_TOL: {errs}")

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
        # meta tensors (the dry run's) get the outputs' shapes, computed by
        # nothing; the launch path refuses any device but CUDA
        outs = ssd_ops.ssd_chunk(*meta)
        assert [tuple(t.shape) for t in outs] == [
            (1, 2, 32, 2, 16), (1, 2, 2, 16, 16), (1, 2, 32, 2), (1, 2, 2)]
        assert all(t.device.type == "meta" for t in outs)
        with pytest.raises(ValueError, match="CPU or CUDA"):
            ssd_ops._check(*meta)
        assert ssd_ops.KERNEL.launches == 0

    @pytest.mark.parametrize("G", [1, 4, 32])
    def test_chip_smoke_bound_counts_scores_once_a_group(self, G):
        """``chip_smoke.ssd_bound`` counts the FLOPs one call needs: C·Bᵀ
        depends only on the group, so it is counted once a group, and the
        products with x once a head.  Checked against a count of the
        multiply-adds of the dense plain version's masked einsums."""
        import importlib.util
        from pathlib import Path
        path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        b, S, H, P, N, Q = 4, 2048, 32, 64, 128, 256
        nc = S // Q
        causal = int(np.tril(np.ones((Q, Q))).sum())   # key-query pairs
        macs = b * nc * (G * causal * N                  # C·Bᵀ per group
                         + H * causal * P                # (C·Bᵀ∘L)·(x·dt)
                         + H * Q * N * P)                # chunk-end states
        peak = 1e3      # 1 ms a FLOP, so operations bound the call
        ms, by = smoke.ssd_bound(b, S, H, P, G, N, Q, 4, peak)
        assert by == "operations"
        assert ms == pytest.approx(2.0 * macs, rel=1e-12)
        if G == 1:      # the main f32 case's 8.9 GFLOP
            assert 2.0 * macs == pytest.approx(8.876e9, rel=1e-3)


# (b, s, h, p, g, n, chunk, with h_init): G < H with an h_init, and G = 2
# over 8 heads at hd 64 without one
CHUNKED_SHAPES = [(2, 64, 8, 16, 4, 16, 32, True),
                  (1, 128, 8, 64, 2, 32, 32, False)]
SSD_INPUTS = ("x", "dt", "A_log", "B", "C", "h_init")


def _chunked_case(seed, b, s, h, p, g, n):
    """SSD inputs, an h_init and cotangents of y and the final state."""
    rng = np.random.default_rng(seed + 100)
    h0 = (rng.standard_normal((b, h, p, n)) * 0.5).astype(np.float32)
    gy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    gh = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return _ssd_inputs(seed, b, s, h, p, g, n) + (h0,), gy, gh


def _port_vjp(fn, inputs, gy, gh):
    """(y, final state, gradients of every input) of ``fn`` by autograd."""
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    y, h = fn(*leaves)
    grads = torch.autograd.grad((y, h), leaves, _t(gy, gh))
    return (y.detach().numpy(), h.detach().numpy(),
            [g.numpy() for g in grads])


class TestSSDChunked:
    """``models/ssm.py::ssd_chunked``, the training scan."""

    @pytest.mark.parametrize("b,s,h,p,g,n,chunk,with_h0", CHUNKED_SHAPES)
    def test_forward_and_gradients_match_jax(self, b, s, h, p, g, n, chunk,
                                             with_h0):
        """y, the final state and the gradient of every input (x, dt,
        A_log, B, C and h_init) against ``jax.vjp`` of the JAX
        ``ssd_chunked`` on the same cotangents, f32, within SSD_TOL of each
        one's scale."""
        inputs, gy, gh = _chunked_case(4, b, s, h, p, g, n)
        if not with_h0:
            inputs = inputs[:5]
        (jy, jh), vjp = jax.vjp(
            lambda *a: jax_ssd_chunked(*a[:5], chunk, *a[5:]),
            *(jnp.asarray(a) for a in inputs))
        jgrads = vjp((jnp.asarray(gy), jnp.asarray(gh)))
        y, hf, grads = _port_vjp(
            lambda *a: ssd_chunked(*a[:5], chunk, *a[5:]), inputs, gy, gh)
        assert _rel_err(y, jy) <= SSD_TOL
        assert _rel_err(hf, jh) <= SSD_TOL
        for name, got, want in zip(SSD_INPUTS, grads, jgrads):
            assert got.shape == want.shape
            assert _rel_err(got, want) <= SSD_TOL, name

    def test_ragged_length_matches_sequential_recurrence(self):
        """S 48 with chunks of 32, where the JAX ``ssd_chunked`` asserts:
        the scan pads with dt = 0, and its output, final state and every
        input's gradient agree with autograd through ``ssd_ref``."""
        b, s, h, p, g, n, chunk = 2, 48, 4, 16, 2, 16, 32
        inputs, gy, gh = _chunked_case(5, b, s, h, p, g, n)
        with pytest.raises(AssertionError, match="48 % chunk 32"):
            jax_ssd_chunked(*(jnp.asarray(a) for a in inputs[:5]), chunk)
        y, hf, grads = _port_vjp(
            lambda *a: ssd_chunked(*a[:5], chunk, *a[5:]), inputs, gy, gh)
        ry, rh, rgrads = _port_vjp(ssd_ref, inputs, gy, gh)
        assert _rel_err(y, ry) <= SSD_TOL
        assert _rel_err(hf, rh) <= SSD_TOL
        for name, got, want in zip(SSD_INPUTS, grads, rgrads):
            assert _rel_err(got, want) <= SSD_TOL, name

    @pytest.mark.parametrize("s", [64, 48])
    def test_no_grad_equals_the_plain_wrapper(self, s):
        """Without autograd the training scan computes what the prefill
        wrapper's plain version does (within SSD_TOL), within 1e-6 of the
        exact recurrence in f64 and no farther from it than the plain
        version, whose ``cum_i − cum_j`` segment sums round more (1.03e-6
        of scale here, all of the two scans' difference); with an input
        that requires grad the wrapper refuses and the scan does not."""
        inputs, _, _ = _chunked_case(6, 2, s, 8, 16, 4, 16)
        args = _t(*inputs[:5])
        h0 = _t(inputs[5])[0]
        with torch.no_grad():
            y, hf = ssd_chunked(*args, 32, h0)
        wy, wh = ssd_ops.ssd(*args, chunk=32, h_init=h0, impl="plain")
        ry, rh = ssd_ref(*(a.double() for a in args), h_init=h0.double())
        for got, plain, exact in ((y, wy, ry), (hf, wh, rh)):
            got, plain, exact = got.numpy(), plain.numpy(), exact.numpy()
            assert _rel_err(got, plain) <= SSD_TOL
            assert _rel_err(got, exact) <= 1e-6
            assert _rel_err(got, exact) <= _rel_err(plain, exact)
        x = args[0].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            ssd_ops.ssd(x, *args[1:], chunk=32, impl="plain")
        assert ssd_chunked(x, *args[1:], 32)[0].requires_grad

    def test_segment_sums_keep_f32_gradients_near_f64(self):
        """At mamba2-370m's decay rates (A up to 16, dt ~ 0.7, chunks of
        256, where cumulative decays reach ~10³ within a chunk) the
        gradient of ``A_log`` through the training scan in f32 stays within
        1e-5 of the exact one's scale (the sequential recurrence in f64);
        JAX's ``cum_i − cum_j`` segment sums, run through the plain chunk
        function, err 10x more."""
        from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref, ssd_scan
        b, s, h, p, g, n = 1, 512, 4, 16, 1, 16
        rng = np.random.default_rng(8)
        x = rng.standard_normal((b, s, h, p))
        dt = np.logaddexp(rng.standard_normal((b, s, h)), 0)
        A = np.log(np.linspace(1.0, 16.0, h))
        B = rng.standard_normal((b, s, g, n))
        C = rng.standard_normal((b, s, g, n))
        gy = torch.from_numpy(rng.standard_normal((b, s, h, p)))

        def exact(x, dt, A_log, B, C):
            """The recurrence in f64 throughout (``ssd_ref`` casts to
            f32)."""
            a = torch.exp(-torch.exp(A_log) * dt)
            hs = torch.zeros((b, h, p, n), dtype=torch.float64)
            ys = []
            for t in range(s):
                xa = (x[:, t] * dt[:, t, :, None])[..., None]
                hs = (hs * a[:, t, :, None, None]
                      + xa * B[:, t, :, None].expand(b, h, 1, n))
                ys.append(torch.einsum("bhn,bhpn->bhp",
                                       C[:, t].expand(b, h, n), hs))
            return torch.stack(ys, dim=1)

        def grad_A(fn, dtype):
            xs = [torch.from_numpy(a).to(dtype) for a in (x, dt, A, B, C)]
            xs[2].requires_grad_(True)
            (gA,) = torch.autograd.grad(fn(*xs), xs[2], gy.to(dtype))
            return gA.double().numpy()

        want = grad_A(exact, torch.float64)
        err_train = _rel_err(grad_A(lambda *a: ssd_chunked(*a, 256)[0],
                                    torch.float32), want)
        err_jax_form = _rel_err(grad_A(lambda *a: ssd_scan(
            *a, chunk=256, chunk_fn=ssd_chunk_ref)[0], torch.float32), want)
        assert err_train <= 1e-5
        assert err_jax_form >= 10 * err_train


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
