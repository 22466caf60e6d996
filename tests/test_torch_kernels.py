"""The PyTorch port's attention kernels on the CPU, against the JAX package.

On CPU tensors each port wrapper runs its plain PyTorch version; it is held
against the JAX Pallas kernel in interpret mode (as tests/test_kernels.py
runs it) on the same numpy inputs, with the same sweeps and tolerances.
The CUDA kernels themselves run only on the GPU (``chip_smoke.py``): here
their launch counters must stay at 0.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.paged_attention.ops import paged_attention as jax_paged
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_tiled_ref
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ref import (merge_partials_ref,
                                                     paged_attention_split_ref)
from repro_torch.launch.profile_serve import _kernel_class

F32_TOL, BF16_TOL = 2e-5, 3e-2     # tests/test_kernels.py:36-39


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


class TestFlashAttention:
    @pytest.mark.parametrize("B,S,H,K,hd,causal,window", [
        (1, 128, 2, 2, 128, True, 0),
        (2, 256, 4, 2, 128, True, 0),       # GQA
        (1, 256, 4, 1, 128, True, 0),       # MQA
        (1, 256, 2, 2, 128, True, 64),      # sliding window
        (2, 128, 4, 4, 128, False, 0),      # bidirectional (encoder)
        (1, 384, 2, 2, 128, True, 100),     # non-pow2 seq, odd window
    ])
    def test_matches_pallas_interpret(self, B, S, H, K, hd, causal, window):
        rng = np.random.default_rng(0)
        q, k, v = (_normal(rng, (B, S, n, hd)) for n in (H, K, K))
        want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, window=window,
                         impl="pallas_interpret")
        got = flash_ops.flash_attention(torch.from_numpy(q),
                                        torch.from_numpy(k),
                                        torch.from_numpy(v), causal=causal,
                                        window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=F32_TOL, rtol=F32_TOL)

    @pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                           ("bfloat16", BF16_TOL)])
    def test_dtypes(self, dtype, tol):
        rng = np.random.default_rng(1)
        q, k, v = (_normal(rng, (1, 128, 2, 128)) for _ in range(3))
        jd, td = getattr(jnp, dtype), getattr(torch, dtype)
        want = jax_flash(*(jnp.asarray(a).astype(jd) for a in (q, k, v)),
                         impl="pallas_interpret")
        got = flash_ops.flash_attention(
            *(torch.from_numpy(a).to(td) for a in (q, k, v)))
        assert got.dtype == td
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=tol, rtol=tol)

    @pytest.mark.parametrize("S,window", [(200, 0), (77, 30)])
    def test_ragged_seq_matches_ref(self, S, window):
        """S not a multiple of 128: the Pallas kernel requires tiles that
        divide S, the CUDA kernel masks instead; held against the JAX ref."""
        rng = np.random.default_rng(2)
        q, k, v = (_normal(rng, (2, S, n, 128)) for n in (4, 2, 2))
        want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         window=window, impl="ref")
        got = flash_ops.flash_attention(torch.from_numpy(q),
                                        torch.from_numpy(k),
                                        torch.from_numpy(v), window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=F32_TOL, rtol=F32_TOL)


class TestFlashTiled:
    """The bf16 kernel's arithmetic (64-key tiles, exp2 online softmax, P
    rounded to bf16 before P·V) against the JAX oracle."""

    @pytest.mark.parametrize("dtype,round_p,tol", [
        ("bfloat16", True, BF16_TOL),   # the kernel's rounding of P
        ("float32", False, F32_TOL),    # the tiling alone is exact
    ])
    @pytest.mark.parametrize("B,S,H,K,causal,window", [
        (1, 192, 2, 2, True, 0),        # causal
        (1, 256, 2, 2, True, 100),      # window
        (2, 128, 8, 2, True, 0),        # GQA
        (2, 77, 4, 2, True, 30),        # ragged S
        (1, 130, 2, 2, False, 0),       # bidirectional
    ])
    def test_tiled_matches_jax_ref(self, dtype, round_p, tol, B, S, H, K,
                                   causal, window):
        rng = np.random.default_rng(5)
        q, k, v = (_normal(rng, (B, S, n, 64)) for n in (H, K, K))
        jd, td = getattr(jnp, dtype), getattr(torch, dtype)
        want = jax_flash(*(jnp.asarray(a).astype(jd) for a in (q, k, v)),
                         causal=causal, window=window, impl="ref")
        got = flash_attention_tiled_ref(
            *(torch.from_numpy(a).to(td).transpose(1, 2) for a in (q, k, v)),
            causal=causal, window=window, round_p=round_p).transpose(1, 2)
        assert got.dtype == td
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=tol, rtol=tol)


class TestPagedSplitMerge:
    """The kernel's two passes (partial states per partition, then their
    merge) against the JAX oracle and the Pallas kernel in interpret mode:
    one batch whose sequences end just before, on and just after a
    partition boundary, at one token and at the table's end."""

    @pytest.mark.parametrize("G", [1, 8])
    @pytest.mark.parametrize("shuffle", [False, True])
    @pytest.mark.parametrize("partition,page", [(16, 8), (64, 16), (256, 16)])
    def test_split_then_merge_matches_jax(self, partition, page, shuffle, G):
        rng = np.random.default_rng(6)
        K, hd = 2, 128
        full = 2 * partition + 2 * page      # the table's width in tokens
        npg = full // page
        lens = np.array([1, partition - 1, partition, partition + 1, full],
                        dtype=np.int32)
        B = len(lens)
        n_pool = B * npg + 3
        q = _normal(rng, (B, G * K, hd))
        kp, vp = (_normal(rng, (n_pool, page, K, hd)) for _ in range(2))
        bt = np.arange(B * npg, dtype=np.int32).reshape(B, npg)
        if shuffle:
            bt = rng.permutation(n_pool)[:B * npg].astype(np.int32)
            bt = bt.reshape(B, npg)
        m, l, o = paged_attention_split_ref(
            *(torch.from_numpy(a) for a in (q, kp, vp, bt, lens)),
            partition=partition)
        assert m.shape == (B, G * K, 3)      # the last partition is partial
        got = merge_partials_ref(m, l, o).numpy()
        args = [jnp.asarray(a) for a in (q, kp, vp, bt, lens)]
        for impl in ("ref", "pallas_interpret"):
            want = jax_paged(*args, impl=impl)
            np.testing.assert_allclose(got, np.asarray(want), atol=F32_TOL,
                                       rtol=F32_TOL, err_msg=impl)

    @pytest.mark.parametrize("width,page", [
        (1, 16), (16, 16), (17, 16), (128, 16), (6, 8), (2, 32), (100, 3),
    ])
    def test_split_count_covers_the_table(self, width, page):
        """The wrapper's split count is a function of the table's width and
        page alone (it never reads seq_lens): the fewest partitions that
        cover ``width · page`` tokens."""
        n = paged_ops.split_count(width, page)
        assert n * paged_ops.PARTITION >= width * page
        assert n == 1 or (n - 1) * paged_ops.PARTITION < width * page
        assert list(inspect.signature(paged_ops.split_count).parameters) == [
            "table_width", "page"]


class TestPagedAttention:
    @pytest.mark.parametrize("B,H,K,hd,page,npg,P", [
        (2, 4, 2, 128, 16, 4, 32),
        (3, 8, 1, 128, 8, 6, 64),           # MQA
        (1, 2, 2, 128, 32, 2, 8),
    ])
    def test_matches_pallas_interpret(self, B, H, K, hd, page, npg, P):
        rng = np.random.default_rng(0)
        q = _normal(rng, (B, H, hd))
        kp = _normal(rng, (P, page, K, hd))
        vp = _normal(rng, (P, page, K, hd))
        bt = rng.choice(P, (B, npg), replace=False).astype(np.int32)
        sl = rng.integers(1, npg * page, (B,)).astype(np.int32)
        want = jax_paged(*(jnp.asarray(a) for a in (q, kp, vp, bt, sl)),
                         impl="pallas_interpret")
        got = paged_ops.paged_attention(
            *(torch.from_numpy(a) for a in (q, kp, vp, bt, sl)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=F32_TOL, rtol=F32_TOL)

    def test_single_token_seq(self):
        rng = np.random.default_rng(3)
        q = _normal(rng, (1, 2, 128))
        kp = _normal(rng, (4, 8, 1, 128))
        vp = _normal(rng, (4, 8, 1, 128))
        bt = np.asarray([[0, 1]], dtype=np.int32)
        sl = np.asarray([1], dtype=np.int32)
        want = jax_paged(*(jnp.asarray(a) for a in (q, kp, vp, bt, sl)),
                         impl="pallas_interpret")
        got = paged_ops.paged_attention(
            *(torch.from_numpy(a) for a in (q, kp, vp, bt, sl)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=F32_TOL, rtol=F32_TOL)


class TestWrappers:
    def test_cpu_never_launches_a_kernel(self):
        flash_ops.KERNEL.launches = 0
        paged_ops.KERNEL.launches = 0
        rng = np.random.default_rng(4)
        q = torch.from_numpy(_normal(rng, (1, 16, 2, 64)))
        flash_ops.flash_attention(q, q, q)
        flash_ops.flash_attention(q, q, q, impl="plain")
        kp = torch.from_numpy(_normal(rng, (2, 8, 2, 64)))
        paged_ops.paged_attention(q[:, 0], kp, kp,
                                  torch.tensor([[0, 1]], dtype=torch.int32),
                                  torch.tensor([9], dtype=torch.int32))
        assert flash_ops.KERNEL.launches == 0
        assert paged_ops.KERNEL.launches == 0

    def test_unknown_impl_raises(self):
        q = torch.zeros((1, 4, 2, 64))
        with pytest.raises(ValueError):
            flash_ops.flash_attention(q, q, q, impl="pallas")
        with pytest.raises(ValueError):
            paged_ops.paged_attention(q[:, 0], q, q, None, None, impl="ref")

    def test_non_cpu_tensor_without_cuda_raises(self):
        """A tensor that is not on the CPU never takes the plain version:
        a device the kernels do not serve is refused, not computed."""
        q = torch.empty((1, 4, 2, 64), device="meta")
        with pytest.raises(ValueError):
            flash_ops.flash_attention(q, q, q)
        kp = torch.empty((2, 8, 2, 64), device="meta")
        bt = torch.empty((1, 2), dtype=torch.int32, device="meta")
        sl = torch.empty((1,), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError):
            paged_ops.paged_attention(q[:, 0], kp, kp, bt, sl)
        assert flash_ops.KERNEL.launches == 0
        assert paged_ops.KERNEL.launches == 0


@pytest.mark.parametrize("name,cls", [
    ("void (anonymous namespace)::tensor_core::flash_fwd_mma_kernel<128>(...)",
     "flash_attention"),
    ("void (anonymous namespace)::cuda_core::flash_fwd_kernel<float, 128>",
     "flash_attention"),
    ("void (anonymous namespace)::paged_split_kernel<__nv_bfloat16, 128, 1>",
     "paged_attention"),
    ("void (anonymous namespace)::paged_merge_kernel<__nv_bfloat16, 128>",
     "paged_attention"),
    ("void (anonymous namespace)::ssd_chunk_kernel<float, 64, 128>",
     "ssd_chunk"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4>", "other"),
])
def test_profiler_classes_count_every_kernel_of_a_source(name, cls):
    """The serve breakdown puts every kernel of the port's sources, the
    merge pass included, under its class and never under "other"."""
    assert _kernel_class(name) == cls
