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

from repro.kernels.flash_attention.kernel import flash_attention_bhsd
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.paged_attention.kernel import paged_attention_kernel
from repro.kernels.paged_attention.ops import paged_attention as jax_paged
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (flash_attention_tiled_ref,
                                                     split_tf32)
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ref import (merge_partials_ref,
                                                     paged_attention_split_ref,
                                                     paged_attention_tiled_ref)
from repro_torch.launch.profile_serve import kernel_class

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
        (1, 256, 8, 2, 80, True, 0),        # h2o-danube's hd 80, G = 4
        (1, 256, 8, 2, 80, True, 64),
        (1, 256, 4, 2, 256, True, 0),       # gemma3's hd 256, G = 2
        (1, 256, 4, 2, 256, True, 64),
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


_TILED_DTYPES = [
    ("bfloat16", True, BF16_TOL),   # the kernel's rounding of P
    ("float32", False, F32_TOL),    # the tiling alone is exact
]
_TILED_CASES = [
    (1, 192, 2, 2, True, 0),        # causal
    (1, 256, 2, 2, True, 100),      # window
    (2, 128, 8, 2, True, 0),        # GQA
    (2, 77, 4, 2, True, 30),        # ragged S
    (1, 130, 2, 2, False, 0),       # bidirectional
]


def _pad_values(v, dk):
    """v (..., dv) with zero columns up to dk: the JAX kernel and its oracle
    take one head width, and the first dv columns of their output are
    attention over v itself."""
    return np.concatenate(
        [v, np.zeros(v.shape[:-1] + (dk - v.shape[-1],), v.dtype)], -1)


class TestFlashTiled:
    """The bf16 kernel's arithmetic (``ops.BF16_KV_TILE``-key tiles of each
    (dk, dv), exp2 online softmax, P rounded to bf16 before P·V) against the
    JAX oracle and the Pallas kernel in interpret mode."""

    @pytest.mark.parametrize("dtype,round_p,tol", _TILED_DTYPES)
    @pytest.mark.parametrize("B,S,H,K,causal,window", _TILED_CASES)
    def test_tiled_matches_jax_ref(self, dtype, round_p, tol, B, S, H, K,
                                   causal, window):
        self._check_jax_ref(dtype, round_p, tol, B, S, H, K, causal, window,
                            64, 64)

    @pytest.mark.parametrize("dk,dv", [d for d in flash_ops.HEAD_DIMS
                                       if d != (64, 64)])
    @pytest.mark.parametrize("dtype,round_p,tol", _TILED_DTYPES)
    @pytest.mark.parametrize("B,S,H,K,causal,window", _TILED_CASES)
    def test_tiled_matches_jax_ref_at_every_width(self, dtype, round_p, tol,
                                                  B, S, H, K, causal, window,
                                                  dk, dv):
        """The cases above at every other (dk, dv) of the kernel."""
        self._check_jax_ref(dtype, round_p, tol, B, S, H, K, causal, window,
                            dk, dv)

    @staticmethod
    def _check_jax_ref(dtype, round_p, tol, B, S, H, K, causal, window, dk,
                       dv):
        rng = np.random.default_rng(5)
        q, k = (_normal(rng, (B, S, n, dk)) for n in (H, K))
        v = _normal(rng, (B, S, K, dv))
        jd, td = getattr(jnp, dtype), getattr(torch, dtype)
        want = jax_flash(*(jnp.asarray(a).astype(jd)
                           for a in (q, k, _pad_values(v, dk))),
                         causal=causal, window=window, impl="ref")
        got = flash_attention_tiled_ref(
            *(torch.from_numpy(a).to(td).transpose(1, 2) for a in (q, k, v)),
            causal=causal, window=window, round_p=round_p,
            tile=flash_ops.BF16_KV_TILE[dk]).transpose(1, 2)
        assert got.dtype == td
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32))
                                   [..., :dv], atol=tol, rtol=tol)

    @pytest.mark.parametrize("dk,dv", flash_ops.HEAD_DIMS)
    @pytest.mark.parametrize("B,C,H,K,causal,window,q_offset,T", [
        (1, 256, 2, 2, True, 0, 0, 256),        # causal, two tiles of 128
        (1, 256, 2, 2, True, 100, 0, 256),      # window
        (2, 128, 8, 2, True, 0, 0, 128),        # GQA
        (1, 256, 2, 2, False, 0, 0, 256),       # bidirectional
        # a chunk of 72 queries at offset 120 (across the tile edge at 128)
        # over the first 192 keys of a 224-row cache, NaN past them
        (1, 72, 2, 2, True, 0, 120, 224),
    ])
    def test_bf16_tiled_matches_pallas_interpret(self, dk, dv, B, C, H, K,
                                                 causal, window, q_offset,
                                                 T):
        """bf16 inputs through the tiled plain version at the kernel's tile
        and the Pallas kernel in interpret mode, within BF16_TOL (the
        Pallas kernel keeps P in f32).  The Pallas kernel has no query
        offset or visible-key count: it runs all kv_len rows over the
        visible keys, and the chunk's rows are kept."""
        rng = np.random.default_rng(dk + dv + C)
        kv_len = q_offset + C
        bf = (lambda a: torch.from_numpy(a).bfloat16())
        q = bf(_normal(rng, (B, kv_len, H, dk)))
        k = bf(_normal(rng, (B, T, K, dk)))
        v = bf(_normal(rng, (B, T, K, dv)))
        k[:, kv_len:] = float("nan")           # never read
        v[:, kv_len:] = float("nan")
        j = (lambda t: jnp.asarray(t[:, :kv_len].float().numpy())
             .astype(jnp.bfloat16).transpose(0, 2, 1, 3))
        want = flash_attention_bhsd(
            j(q), j(k), j(torch.from_numpy(_pad_values(
                v.float().numpy(), dk)).bfloat16()),
            causal=causal, window=window, interpret=True)
        want = np.asarray(want.astype(jnp.float32))[:, :, q_offset:, :dv]
        got = flash_attention_tiled_ref(
            q[:, q_offset:].transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2), causal=causal, window=window,
            q_offset=q_offset, kv_len=kv_len,
            tile=flash_ops.BF16_KV_TILE[dk]).float().numpy()
        assert got.shape == want.shape == (B, H, C, dv)
        np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL)


class TestFlashTF32x3:
    """The f32 kernel's arithmetic (``flash_attention_tiled_ref`` with
    ``tf32_products=3``: Q·Kᵀ and P·V as three TF32 products of operands
    split by ``split_tf32``, the kernel's KV tile) against the JAX Pallas
    kernel in interpret mode: within F32_TOL, where one TF32 product a
    multiply is not, which is why the kernel takes three."""

    @pytest.mark.parametrize("tf32_products", [3, 1])
    @pytest.mark.parametrize("dk,dv,q_offset", [
        (128, 128, 0),      # llama2's widths
        (192, 128, 0),      # MLA prefill in MHA form
        (128, 128, 192),    # a chunk at an offset, NaN past the visible keys
        (96, 64, 0),        # minicpm3's MLA prefill in MHA form
        (96, 64, 192),      # and its chunk at an offset
    ])
    def test_three_tf32_products_hold_f32_one_does_not(self, dk, dv,
                                                       q_offset,
                                                       tf32_products):
        rng = np.random.default_rng(21)
        B, H, K = 1, 4, 2
        C = 64 if q_offset else 128
        kv_len = q_offset + C
        q = _normal(rng, (B, kv_len, H, dk))      # every row up to kv_len
        k = _normal(rng, (B, kv_len + 32, K, dk))
        v = _normal(rng, (B, kv_len + 32, K, dv))
        k[:, kv_len:] = np.nan                    # never read
        v[:, kv_len:] = np.nan
        # The Pallas kernel has no query offset and one head width: it runs
        # all kv_len rows causally over the visible keys, values padded
        # with zero columns to dk, and the chunk's rows and the first dv
        # columns of its output are kept.
        vpad = np.concatenate(
            [v, np.zeros(v.shape[:3] + (dk - dv,), np.float32)], -1)
        want = flash_attention_bhsd(
            *(jnp.asarray(a[:, :kv_len]).transpose(0, 2, 1, 3)
              for a in (q, k, vpad)), causal=True, interpret=True)
        want = np.asarray(want)[:, :, q_offset:, :dv]
        got = flash_attention_tiled_ref(
            torch.from_numpy(q[:, q_offset:]).transpose(1, 2),
            *(torch.from_numpy(a).transpose(1, 2) for a in (k, v)),
            q_offset=q_offset, kv_len=kv_len,
            tile=flash_ops.F32_KV_TILE[dk], round_p=False,
            tf32_products=tf32_products).numpy()
        assert got.shape == want.shape == (B, H, C, dv)
        worst = float(np.max(np.abs(got - want)
                             / (F32_TOL + F32_TOL * np.abs(want))))
        err = float(np.max(np.abs(got - want)))
        print(f"{tf32_products} TF32 product(s) a multiply at ({dk}, {dv}) "
              f"q_offset {q_offset}: max abs err {err:.3g}, worst |d| / "
              f"(F32_TOL + F32_TOL·|ref|) {worst:.3g}")
        if tf32_products == 3:
            np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
        else:
            assert worst > 1.0, (f"one TF32 product held F32_TOL (max abs "
                                 f"err {err:.3g}, worst ratio {worst:.3g})")

    def test_split_tf32_rounds_big_to_nearest_and_truncates_small(self):
        """big: to nearest on 10 explicit mantissa bits, ties away from zero
        (``cvt.rna.tf32.f32``); small: the remainder truncated to TF32; the
        pair holds x to 2^-21 of it; zeros, infinities and NaNs pass."""
        ulp = 2.0 ** -10                       # TF32's ulp at 1
        x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                          1 + 1.5 * ulp, 0.0, float("inf")])
        big, small = split_tf32(x)
        assert big.tolist()[:4] == [1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp]
        assert big.tolist()[4:] == [0.0, float("inf")]
        # the remainder 2^-11 - 2^-23 has 12 significant bits: truncated
        assert small.tolist()[:5] == [-ulp / 2, ulp / 2, ulp / 2 - 2 ** -22,
                                      -ulp / 2, 0.0]
        assert bool(small[5].isnan())          # inf - inf
        nan = torch.tensor([0x7FFFFFFF], dtype=torch.int32).view(torch.float32)
        assert bool(split_tf32(nan)[1].isnan())
        r = torch.from_numpy(_normal(np.random.default_rng(22), (4096,)))
        big, small = split_tf32(r)
        for part in (big, small):              # low 13 bits clear
            assert not (part.view(torch.int32) & 0x1FFF).any()
        assert float(((big + small - r).abs() / r.abs()).max()) <= 2.0 ** -21


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
        (3, 8, 2, 80, 16, 4, 12),           # h2o-danube's hd 80, G = 4
        (3, 4, 2, 256, 16, 4, 12),          # gemma3's hd 256, G = 2
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


class TestPagedRecurrentGemma:
    """recurrentgemma-9b's decode instance: hd 256, G = 16 query heads a KV
    head (MQA at full width), which the CUDA kernel runs as two head tiles
    of 8.  Its plain versions (the wrapper's, and split then merge over
    ``PARTITION``-token partitions) against the Pallas kernel in interpret
    mode: lengths on and across the partition edges, a shuffled table."""

    @pytest.mark.parametrize("K", [1, 2])
    def test_g16_plain_versions_match_pallas_interpret(self, K):
        rng = np.random.default_rng(16 + K)
        P, page, hd, G = paged_ops.PARTITION, 16, 256, 16
        lens = np.array([1, P - 1, P, P + 1, 2 * P, 2 * P + 1, 700],
                        dtype=np.int32)
        B, npg = len(lens), 3 * P // page
        n_pool = B * npg + 5
        q = _normal(rng, (B, G * K, hd))
        kp, vp = (_normal(rng, (n_pool, page, K, hd)) for _ in range(2))
        bt = rng.permutation(n_pool)[:B * npg].astype(np.int32).reshape(
            B, npg)
        args = (q, kp, vp, bt, lens)
        want = np.asarray(jax_paged(*(jnp.asarray(a) for a in args),
                                    impl="pallas_interpret"))
        got = paged_ops.paged_attention(*(torch.from_numpy(a) for a in args))
        np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL,
                                   rtol=F32_TOL)
        m, l, o = paged_attention_split_ref(
            *(torch.from_numpy(a) for a in args), partition=P)
        assert m.shape == (B, G * K, paged_ops.split_count(npg, page))
        np.testing.assert_allclose(merge_partials_ref(m, l, o).numpy(), want,
                                   atol=F32_TOL, rtol=F32_TOL)
        assert paged_ops.KERNEL.launches == 0
        assert 16 in paged_ops.GROUPS


class TestPagedGQATiled:
    """The bf16 grouped tensor-core kernel's arithmetic
    (``paged_attention_tiled_ref`` over ``GQA_PARTITION``-token partitions:
    32-token tiles, the tile's max over all its tokens, exp2 online softmax,
    P rounded to bf16 before P·V when ``round_p``) with keys and values in
    pages of their own, at every width and group the kernel takes, against
    the Pallas kernel in interpret mode: exact to F32_TOL without the
    rounding, within the bf16 limit with it (on bf16-representable inputs).
    Lengths of one token, on both sides of a tile edge and of the partition
    edge; a shuffled table."""

    _want = {}

    @classmethod
    def _case(cls, hd, G):
        """The inputs (rounded to bf16) and the Pallas kernel's output in
        f32, once for each (hd, G)."""
        if (hd, G) not in cls._want:
            rng = np.random.default_rng(hd * 100 + G)
            P, page = paged_ops.GQA_PARTITION, 16
            K = 2 if G <= 4 else 1
            lens = np.array([1, 31, 33, P - 1, P + 1], dtype=np.int32)
            B, npg = len(lens), (P + 32) // page
            n_pool = B * npg + 3
            bf = lambda a: torch.from_numpy(a).bfloat16().float().numpy()
            q = bf(_normal(rng, (B, G * K, hd)))
            kp, vp = (bf(_normal(rng, (n_pool, page, K, hd)))
                      for _ in range(2))
            bt = rng.permutation(n_pool)[:B * npg].astype(np.int32).reshape(
                B, npg)
            args = (q, kp, vp, bt, lens)
            want = np.asarray(jax_paged(*(jnp.asarray(a) for a in args),
                                        impl="pallas_interpret"))
            cls._want[hd, G] = args, want
        return cls._want[hd, G]

    @pytest.mark.parametrize("round_p", [False, True])
    @pytest.mark.parametrize("G", [2, 4, 8, 16])
    @pytest.mark.parametrize("hd", [64, 80, 128, 256])
    def test_tiled_matches_pallas_interpret(self, hd, G, round_p):
        (q, kp, vp, bt, lens), want = self._case(hd, G)
        dtype = torch.bfloat16 if round_p else torch.float32
        t = [torch.from_numpy(a) for a in (q, kp, vp)]
        got = paged_attention_tiled_ref(
            *(a.to(dtype) for a in t), torch.from_numpy(bt),
            torch.from_numpy(lens), partition=paged_ops.GQA_PARTITION,
            round_p=round_p)
        assert got.shape == want.shape and got.dtype == dtype
        P = paged_ops.GQA_PARTITION
        assert P < bt.shape[1] * 16 <= 2 * P      # two partitions
        tol = BF16_TOL if round_p else F32_TOL
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=tol)
        assert paged_ops.KERNEL.launches == 0


def _dense_attention(q, k, v, scale, mask):
    """Softmax attention in float64 numpy: q (B,H,S,dk), k (B,H,T,dk),
    v (B,H,T,dv), mask (B or 1, 1, S, T) → (B,H,S,dv)."""
    s = np.einsum("bhsd,bhtd->bhst", q.astype(np.float64),
                  k.astype(np.float64)) * scale
    s = np.where(mask, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhst,bhtd->bhsd", p, v.astype(np.float64))


class TestWideKeys:
    """Keys wider than values, the MLA shapes: prefill folded into MHA form
    (q/k 192 = 128 + 64 rope, v 128) through flash attention, and absorbed
    decode (keys 576 = latent 512 + rope 64, values the first 512 columns
    of the same rows, a strided view) through paged attention; both plain
    versions against dense softmax attention."""

    @pytest.mark.parametrize("B,S,H,K,q_offset,kv_len,scale", [
        (2, 70, 4, 4, 0, None, 192 ** -0.5),   # MLA prefill: H = K
        (1, 64, 4, 2, 0, None, None),          # GQA, default hd^-0.5
        (1, 20, 2, 2, 50, 70, 192 ** -0.5),    # at an offset into a cache
    ])
    def test_flash_plain_versions_match_dense(self, B, S, H, K, q_offset,
                                              kv_len, scale):
        rng = np.random.default_rng(11)
        T = q_offset + S if kv_len is None else kv_len + 10
        q = _normal(rng, (B, S, H, 192))
        k = _normal(rng, (B, T, K, 192))
        v = _normal(rng, (B, T, K, 128))
        vis = q_offset + S if kv_len is None else kv_len
        qpos = q_offset + np.arange(S)[:, None]
        mask = (np.arange(vis)[None] <= qpos)[None, None]
        G = H // K
        want = _dense_attention(
            q.transpose(0, 2, 1, 3),
            np.repeat(k[:, :vis], G, axis=2).transpose(0, 2, 1, 3),
            np.repeat(v[:, :vis], G, axis=2).transpose(0, 2, 1, 3),
            192 ** -0.5 if scale is None else scale, mask)
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        got = flash_ops.flash_attention(tq, tk, tv, scale=scale,
                                        q_offset=q_offset, kv_len=kv_len)
        assert got.shape == (B, S, H, 128)
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 1, 3), want,
                                   atol=F32_TOL, rtol=F32_TOL)
        tiled = flash_attention_tiled_ref(
            tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
            scale=scale, q_offset=q_offset, kv_len=kv_len, round_p=False)
        np.testing.assert_allclose(tiled.numpy(), want, atol=F32_TOL,
                                   rtol=F32_TOL)

    @pytest.mark.parametrize("G,page,lens", [
        (16, 16, [1, 37, 128, 129, 300]),   # one token; partial last page
        (4, 8, [5, 64, 250]),
    ])
    def test_paged_strided_values_match_dense(self, G, page, lens):
        rng = np.random.default_rng(12)
        dk, dv = paged_ops.MLA_DIMS
        lens = np.asarray(lens, dtype=np.int32)
        B = len(lens)
        npg = -(-int(lens.max()) // page) + 1
        n_pool = B * npg + 2
        q = _normal(rng, (B, G, dk))
        rows = _normal(rng, (n_pool, page, 1, dk))
        bt = rng.permutation(n_pool)[:B * npg].astype(np.int32).reshape(B, npg)
        kp = torch.from_numpy(rows)
        vp = kp[..., :dv]                      # the values: a strided view
        assert not vp.is_contiguous() and vp.stride() == kp.stride()
        scale = 192 ** -0.5
        gathered = rows[bt].reshape(B, npg * page, dk)
        mask = (np.arange(npg * page)[None] < lens[:, None])[:, None, None]
        want = _dense_attention(
            q[:, :, None], np.repeat(gathered[:, None], G, 1),
            np.repeat(gathered[:, None, :, :dv], G, 1), scale, mask)[:, :, 0]
        args = (torch.from_numpy(q), kp, vp, torch.from_numpy(bt),
                torch.from_numpy(lens))
        got = paged_ops.paged_attention(*args, scale=scale)
        assert got.shape == (B, G, dv)
        np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL,
                                   rtol=F32_TOL)
        m, l, o = paged_attention_split_ref(
            *args, partition=paged_ops.MLA_PARTITION, scale=scale)
        assert o.shape == (B, G, paged_ops.mla_split_count(npg, page), dv)
        np.testing.assert_allclose(merge_partials_ref(m, l, o).numpy(), want,
                                   atol=F32_TOL, rtol=F32_TOL)

    @pytest.mark.parametrize("round_p", [False, True])
    @pytest.mark.parametrize("G,page,partition,lens", [
        # one token; partial last pages; both sides of the 64-token edge
        (16, 16, 64, [1, 31, 32, 33, 63, 64, 65, 130]),
        (4, 16, 128, [1, 17, 127, 128, 129, 300]),
        (16, 8, 128, [5, 64, 250]),
        (4, 16, 64, [64, 65, 96, 129]),
    ])
    def test_paged_mla_tiled_matches_dense(self, G, page, partition, lens,
                                           round_p):
        """The bf16 MLA kernel's arithmetic (32-token tiles of each
        partition, exp2 online softmax, P rounded to bf16 before P·V when
        ``round_p``) against dense softmax attention: exact to F32_TOL
        without the rounding, within the bf16 limit with it (on bf16
        inputs, the dense version taking the same rounded values)."""
        rng = np.random.default_rng(13)
        dk, dv = paged_ops.MLA_DIMS
        lens = np.asarray(lens, dtype=np.int32)
        B = len(lens)
        npg = -(-int(lens.max()) // page) + 1
        n_pool = B * npg + 2
        dtype = torch.bfloat16 if round_p else torch.float32
        q = torch.from_numpy(_normal(rng, (B, G, dk))).to(dtype)
        kp = torch.from_numpy(_normal(rng, (n_pool, page, 1, dk))).to(dtype)
        bt = rng.permutation(n_pool)[:B * npg].astype(np.int32).reshape(B, npg)
        scale = 192 ** -0.5
        rows = kp.float().numpy()
        gathered = rows[bt].reshape(B, npg * page, dk)
        mask = (np.arange(npg * page)[None] < lens[:, None])[:, None, None]
        want = _dense_attention(
            q.float().numpy()[:, :, None], np.repeat(gathered[:, None], G, 1),
            np.repeat(gathered[:, None, :, :dv], G, 1), scale, mask)[:, :, 0]
        got = paged_attention_tiled_ref(q, kp, kp[..., :dv], torch.from_numpy(bt),
                                  torch.from_numpy(lens), partition=partition,
                                  scale=scale, round_p=round_p)
        assert got.shape == (B, G, dv) and got.dtype == dtype
        tol = BF16_TOL if round_p else F32_TOL
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=tol)


    @pytest.mark.parametrize("round_p", [False, True])
    @pytest.mark.parametrize("B,S,q_offset,kv_len", [
        (2, 70, 0, None),       # minicpm3 prefill in MHA form, H = K
        (1, 20, 50, 70),        # a chunk at an offset into a cache
        (1, 1, 69, 70),         # a chunk of one token
    ])
    def test_minicpm3_flash_plain_versions_match_dense(self, B, S, q_offset,
                                                       kv_len, round_p):
        """minicpm3-4b's widths, q/k 96 (64 + 32 rope) and v 64, scale
        96^-0.5, through the flash plain version and the tiled one (P
        rounded to bf16 as the bf16 kernel does, on bf16 inputs, when
        ``round_p``; each f32 product split into three TF32 products with
        the f32 kernel's tile otherwise) against dense softmax attention;
        keys past ``kv_len`` hold NaN and are never read."""
        rng = np.random.default_rng(14)
        H, dk, dv, scale = 4, 96, 64, 96 ** -0.5
        T = q_offset + S if kv_len is None else kv_len + 10
        vis = q_offset + S if kv_len is None else kv_len
        dtype = torch.bfloat16 if round_p else torch.float32
        tq, tk, tv = (torch.from_numpy(_normal(rng, shape)).to(dtype)
                      for shape in ((B, S, H, dk), (B, T, H, dk),
                                    (B, T, H, dv)))
        tk[:, vis:] = float("nan")
        tv[:, vis:] = float("nan")
        q, k, v = (t.float().numpy() for t in (tq, tk, tv))
        qpos = q_offset + np.arange(S)[:, None]
        mask = (np.arange(vis)[None] <= qpos)[None, None]
        want = _dense_attention(q.transpose(0, 2, 1, 3),
                                k[:, :vis].transpose(0, 2, 1, 3),
                                v[:, :vis].transpose(0, 2, 1, 3), scale, mask)
        tol = BF16_TOL if round_p else F32_TOL
        got = flash_ops.flash_attention(tq, tk, tv, scale=scale,
                                        q_offset=q_offset, kv_len=kv_len)
        assert got.shape == (B, S, H, dv) and got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy().transpose(0, 2, 1, 3),
                                   want, atol=tol, rtol=tol)
        rounding = (dict(round_p=True) if round_p else
                    dict(round_p=False, tf32_products=3,
                         tile=flash_ops.F32_KV_TILE[dk]))
        tiled = flash_attention_tiled_ref(
            tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
            scale=scale, q_offset=q_offset, kv_len=kv_len, **rounding)
        np.testing.assert_allclose(tiled.float().numpy(), want, atol=tol,
                                   rtol=tol)

    @pytest.mark.parametrize("round_p", [False, True])
    def test_minicpm3_paged_mla_tiled_matches_dense(self, round_p):
        """minicpm3-4b's absorbed decode, keys of 288 (latent 256 + rope
        32), values the rows' first 256 columns, G = 40 heads (three M
        tiles in the kernels), through the wrapper's plain version and the
        bf16 kernel's tiled arithmetic (P in bf16 when ``round_p``, on bf16
        inputs) against dense softmax attention; lens on and across the
        tile and partition edges."""
        rng = np.random.default_rng(15)
        G, page, scale = 40, 16, 96 ** -0.5
        dk, dv = 288, 256
        assert paged_ops.MLA_SHAPES[dk, dv] == (G,)
        lens = np.asarray([1, 31, 32, 33, 127, 128, 129, 300], np.int32)
        B = len(lens)
        npg = -(-int(lens.max()) // page) + 1
        n_pool = B * npg + 2
        dtype = torch.bfloat16 if round_p else torch.float32
        q = torch.from_numpy(_normal(rng, (B, G, dk))).to(dtype)
        kp = torch.from_numpy(_normal(rng, (n_pool, page, 1, dk))).to(dtype)
        bt = rng.permutation(n_pool)[:B * npg].astype(np.int32).reshape(B, npg)
        rows = kp.float().numpy()
        gathered = rows[bt].reshape(B, npg * page, dk)
        mask = (np.arange(npg * page)[None] < lens[:, None])[:, None, None]
        want = _dense_attention(
            q.float().numpy()[:, :, None], np.repeat(gathered[:, None], G, 1),
            np.repeat(gathered[:, None, :, :dv], G, 1), scale, mask)[:, :, 0]
        args = (q, kp, kp[..., :dv], torch.from_numpy(bt),
                torch.from_numpy(lens))
        tol = BF16_TOL if round_p else F32_TOL
        plain = paged_ops.paged_attention(*args, scale=scale)
        got = paged_attention_tiled_ref(*args, partition=paged_ops.MLA_PARTITION,
                                  scale=scale, round_p=round_p)
        for out in (plain, got):
            assert out.shape == (B, G, dv) and out.dtype == dtype
            np.testing.assert_allclose(out.float().numpy(), want, atol=tol,
                                       rtol=tol)


class TestPagedMLATF32x3:
    """The f32 MLA decode kernel's arithmetic (``paged_attention_tiled_ref`` with
    ``tf32_products=3``: Q·Kᵀ and P·V as three TF32 products of operands
    split by ``split_tf32``, 32-token tiles of each ``MLA_PARTITION``-token
    partition) against the JAX Pallas kernel in interpret mode at keys of
    576, values the same rows (the Pallas kernel takes one head width, so
    its output's first 512 columns are kept): within F32_TOL, where one
    TF32 product a multiply is not."""

    @pytest.mark.parametrize("tf32_products", [3, 1])
    @pytest.mark.parametrize("G,lens", [
        # one token; on and across the 32-token tile and 128-token
        # partition edges; a sequence of three partitions
        (16, [1, 31, 32, 33, 127, 128, 129, 300]),
        (4, [1, 32, 64, 128, 129, 256, 257]),
    ])
    def test_three_tf32_products_hold_f32_one_does_not(self, G, lens,
                                                       tf32_products):
        rng = np.random.default_rng(22)
        dk, dv = paged_ops.MLA_DIMS
        page, scale = 16, 192 ** -0.5
        lens = np.asarray(lens, dtype=np.int32)
        B = len(lens)
        npg = -(-int(lens.max()) // page) + 1
        n_pool = B * npg + 2
        q = _normal(rng, (B, G, dk))
        rows = _normal(rng, (n_pool, page, 1, dk))
        bt = rng.permutation(n_pool)[:B * npg].astype(np.int32).reshape(B, npg)
        want = paged_attention_kernel(
            *(jnp.asarray(a) for a in (q, rows, rows, bt, lens)), scale=scale,
            interpret=True)
        want = np.asarray(want)[:, :, :dv]
        kp = torch.from_numpy(rows)
        got = paged_attention_tiled_ref(
            torch.from_numpy(q), kp, kp[..., :dv], torch.from_numpy(bt),
            torch.from_numpy(lens), partition=paged_ops.MLA_PARTITION,
            scale=scale, round_p=False, tf32_products=tf32_products).numpy()
        assert got.shape == want.shape == (B, G, dv)
        worst = float(np.max(np.abs(got - want)
                             / (F32_TOL + F32_TOL * np.abs(want))))
        err = float(np.max(np.abs(got - want)))
        print(f"{tf32_products} TF32 product(s) a multiply, MLA decode G "
              f"{G}: max abs err {err:.3g}, worst |d| / (F32_TOL + "
              f"F32_TOL·|ref|) {worst:.3g}")
        if tf32_products == 3:
            np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
        else:
            assert worst > 1.0, (f"one TF32 product held F32_TOL (max abs "
                                 f"err {err:.3g}, worst ratio {worst:.3g})")

    @pytest.mark.parametrize("tf32_products", [3, 1])
    def test_minicpm3_three_tf32_products_hold_f32_one_does_not(
            self, tf32_products):
        """The same at minicpm3-4b's widths: keys of 288, values the first
        256 columns, G = 40 heads."""
        rng = np.random.default_rng(23)
        dk, dv, G = 288, 256, 40
        page, scale = 16, 96 ** -0.5
        lens = np.asarray([1, 32, 33, 128, 129, 300], dtype=np.int32)
        B = len(lens)
        npg = -(-int(lens.max()) // page) + 1
        n_pool = B * npg + 2
        q = _normal(rng, (B, G, dk))
        rows = _normal(rng, (n_pool, page, 1, dk))
        bt = rng.permutation(n_pool)[:B * npg].astype(np.int32).reshape(B, npg)
        want = paged_attention_kernel(
            *(jnp.asarray(a) for a in (q, rows, rows, bt, lens)), scale=scale,
            interpret=True)
        want = np.asarray(want)[:, :, :dv]
        kp = torch.from_numpy(rows)
        got = paged_attention_tiled_ref(
            torch.from_numpy(q), kp, kp[..., :dv], torch.from_numpy(bt),
            torch.from_numpy(lens), partition=paged_ops.MLA_PARTITION,
            scale=scale, round_p=False, tf32_products=tf32_products).numpy()
        assert got.shape == want.shape == (B, G, dv)
        worst = float(np.max(np.abs(got - want)
                             / (F32_TOL + F32_TOL * np.abs(want))))
        err = float(np.max(np.abs(got - want)))
        print(f"{tf32_products} TF32 product(s) a multiply, MLA decode "
              f"(288, 256) G 40: max abs err {err:.3g}, worst |d| / "
              f"(F32_TOL + F32_TOL·|ref|) {worst:.3g}")
        if tf32_products == 3:
            np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
        else:
            assert worst > 1.0, (f"one TF32 product held F32_TOL (max abs "
                                 f"err {err:.3g}, worst ratio {worst:.3g})")

    def test_tf32_products_do_not_round_p_too(self):
        """P is rounded to bf16 (the bf16 kernel) or split into TF32 (the
        f32 one), never both; and only 0, 1 or 3 products are known."""
        z = torch.zeros((1, 16, 576))
        kp = torch.zeros((2, 16, 1, 576))
        args = (z, kp, kp[..., :512], torch.zeros((1, 2), dtype=torch.int32),
                torch.ones((1,), dtype=torch.int32))
        with pytest.raises(ValueError):
            paged_attention_tiled_ref(*args, partition=128, tf32_products=3)
        with pytest.raises(ValueError):
            paged_attention_tiled_ref(*args, partition=128, round_p=False,
                                tf32_products=2)


class TestPagedGQATF32x3:
    """The f32 grouped decode kernel's arithmetic
    (``paged_attention_tiled_ref`` with ``tf32_products=3``, ``round_p=False``
    over ``GQA_PARTITION``-token partitions: 32-token tiles, the tile's
    max, Q·Kᵀ and P·V as three TF32 products of operands split by
    ``split_tf32``, the sum on P unsplit) with keys and values in pages of
    their own, at every width and group ``paged_gqa_tf32x3_kernel`` takes,
    against the Pallas kernel in interpret mode: within F32_TOL, where one
    TF32 product a multiply is not (at hd 128 and 256).  The inputs are f32
    normals not rounded to bf16 (on bf16 values one TF32 product is exact);
    lengths of one token, on both sides of a tile edge and of the partition
    edge; a shuffled table."""

    _want = {}

    @classmethod
    def _case(cls, hd, G):
        """The f32 inputs and the Pallas kernel's output, once for each
        (hd, G)."""
        if (hd, G) not in cls._want:
            rng = np.random.default_rng(hd * 100 + G + 50)
            P, page = paged_ops.GQA_PARTITION, 16
            K = 2 if G <= 4 else 1
            lens = np.array([1, 31, 33, P - 1, P + 1], dtype=np.int32)
            B, npg = len(lens), (P + 32) // page
            n_pool = B * npg + 3
            q = _normal(rng, (B, G * K, hd))
            kp, vp = (_normal(rng, (n_pool, page, K, hd)) for _ in range(2))
            bt = rng.permutation(n_pool)[:B * npg].astype(np.int32).reshape(
                B, npg)
            args = (q, kp, vp, bt, lens)
            want = np.asarray(paged_attention_kernel(
                *(jnp.asarray(a) for a in args), interpret=True))
            cls._want[hd, G] = args, want
        return cls._want[hd, G]

    def _tiled(self, hd, G, tf32_products):
        args, want = self._case(hd, G)
        got = paged_attention_tiled_ref(
            *(torch.from_numpy(a) for a in args),
            partition=paged_ops.GQA_PARTITION, round_p=False,
            tf32_products=tf32_products).numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        P = paged_ops.GQA_PARTITION
        assert P < args[3].shape[1] * 16 <= 2 * P      # two partitions
        worst = float(np.max(np.abs(got - want)
                             / (F32_TOL + F32_TOL * np.abs(want))))
        print(f"{tf32_products} TF32 product(s) a multiply, grouped decode "
              f"hd {hd} G {G}: max abs err "
              f"{float(np.max(np.abs(got - want))):.3g}, worst |d| / "
              f"(F32_TOL + F32_TOL·|ref|) {worst:.3g}")
        return got, want, worst

    @pytest.mark.parametrize("G", [2, 4, 8, 16])
    @pytest.mark.parametrize("hd", [64, 80, 128, 256])
    def test_three_tf32_products_hold_f32(self, hd, G):
        got, want, _ = self._tiled(hd, G, 3)
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
        assert paged_ops.KERNEL.launches == 0

    @pytest.mark.parametrize("G", [2, 4, 8, 16])
    @pytest.mark.parametrize("hd", [128, 256])
    def test_one_tf32_product_does_not(self, hd, G):
        _, _, worst = self._tiled(hd, G, 1)
        assert worst > 1.0, f"one TF32 product held F32_TOL (worst {worst:.3g})"

    @pytest.mark.parametrize("G", [1, 2, 4, 8, 16])
    @pytest.mark.parametrize("hd", paged_ops.HEAD_DIMS)
    def test_partition_by_type_and_group(self, hd, G):
        """Groups of 2 or more walk the grouped tensor-core kernels'
        partitions in both types (f32 on ``paged_gqa_tf32x3_kernel`` since
        it replaced the split kernel there), G = 1 the split kernel's."""
        want = paged_ops.GQA_PARTITION if G > 1 else paged_ops.PARTITION
        assert paged_ops.partition_for(hd, hd, G, torch.float32) == want
        assert paged_ops.partition_for(hd, hd, G, torch.bfloat16) == want


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

    def test_non_cpu_tensor_without_cuda_raises(self, monkeypatch):
        """A tensor that is not on the CPU never takes the plain version:
        meta tensors (the dry run's) get their outputs' shapes and launch
        nothing, and the launch path refuses any device but CUDA."""
        def plain(*a, **k):
            raise AssertionError("the plain version ran on meta tensors")
        monkeypatch.setattr(flash_ops, "flash_attention_ref", plain)
        monkeypatch.setattr(paged_ops, "paged_attention_ref", plain)
        q = torch.empty((1, 4, 2, 64), device="meta")
        out = flash_ops.flash_attention(q, q, q)
        assert out.device.type == "meta" and out.shape == q.shape
        kp = torch.empty((2, 8, 2, 64), device="meta")
        bt = torch.empty((1, 2), dtype=torch.int32, device="meta")
        sl = torch.empty((1,), dtype=torch.int32, device="meta")
        out = paged_ops.paged_attention(q[:, 0], kp, kp, bt, sl)
        assert out.device.type == "meta" and out.shape == (1, 2, 64)
        with pytest.raises(ValueError, match="CPU or CUDA"):
            flash_ops._check(q, q, q, 0)
        with pytest.raises(ValueError, match="CPU or CUDA"):
            paged_ops._check(q[:, 0], kp, kp, bt, sl)
        assert flash_ops.KERNEL.launches == 0
        assert paged_ops.KERNEL.launches == 0


@pytest.mark.parametrize("name,cls", [
    ("void (anonymous namespace)::tensor_core::flash_fwd_mma_kernel<128>(...)",
     "flash_attention"),
    ("void (anonymous namespace)::tf32x3::flash_fwd_tf32x3_kernel<128, 128>"
     "(float const*, float const*, float const*, float*, int, int, int, int, "
     "int, int, float, int, int)", "flash_attention"),
    ("void (anonymous namespace)::paged_split_kernel<__nv_bfloat16, 128, 1>",
     "paged_attention"),
    ("void (anonymous namespace)::paged_merge_kernel<__nv_bfloat16, 128>",
     "paged_attention"),
    ("void (anonymous namespace)::tensor_core::flash_fwd_mma_kernel<192, 128>"
     "(...)", "flash_attention"),
    ("void (anonymous namespace)::wgmma_tc::flash_fwd_wgmma_kernel<128, 128>"
     "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, int, int, int, int, "
     "int, float, int, int)", "flash_attention"),
    ("void (anonymous namespace)::wgmma_tc::flash_fwd_wgmma_kernel<80, 80>"
     "(...)", "flash_attention"),
    ("void (anonymous namespace)::mla::paged_mla_tf32x3_kernel<576, 512, 16>"
     "(float const*, float const*, int const*, int const*, float*, float*, "
     "int, int, int, int, int, int, float)", "paged_attention"),
    ("void (anonymous namespace)::mla::paged_mla_mma_kernel<576, 512, 16>"
     "(__nv_bfloat16 const*, __nv_bfloat16 const*, int const*, int const*, "
     "__nv_bfloat16*, float*, int, int, int, int, int, int, float)",
     "paged_attention"),
    ("void (anonymous namespace)::gqa::paged_gqa_mma_kernel<256, 16>"
     "(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
     "int const*, int const*, __nv_bfloat16*, float*, int, int, int, int, "
     "int, int, float)", "paged_attention"),
    ("void (anonymous namespace)::gqa::paged_gqa_tf32x3_kernel<256, 16>"
     "(float const*, float const*, float const*, int const*, int const*, "
     "float*, float*, int, int, int, int, int, int, float)",
     "paged_attention"),
    ("void at::native::index_add_cuda_impl<float>", "moe_dispatch"),
    ("void (anonymous namespace)::tf32x3::ssd_chunk_y_tf32x3_kernel<64, 16, "
     "4>(float const*, float const*, float const*, float const*, "
     "float const*, float*, int, int, int, int, int, int)", "ssd_chunk"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4>", "other"),
    # kernels of a training step (``launch/profile_train.py``)
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", "matmul"),
    ("void at::native::tensor_kernel_scan_outer_dim<float>", "cumsum"),
    ("void at::native::index_elementwise_kernel<flip_kernel_impl>",
     "cumsum"),
    ("void at::native::CatArrayBatchedCopy<OpaqueType<4u>>", "copy"),
    ("Memcpy DtoD (Device -> Device)", "copy"),
    ("Memcpy HtoD (Pageable -> Device)", "copy_host_device"),
    ("void at::native::reduce_kernel<512, 1>", "reduce"),
])
def test_profiler_classes_count_every_kernel_of_a_source(name, cls):
    """The serve and train breakdowns put every kernel of the port's
    sources, the merge pass included, under its class and never under
    "other", and a training step's scans, copies and reductions under
    theirs."""
    assert kernel_class(name) == cls


def _wrapper_calls(device="cpu"):
    """Each kernel wrapper called on small inputs, the first tensor of each
    built by ``make`` (so a test can make it require grad)."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    g = torch.Generator(device=device).manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g, device=device)

    def flash(make):
        return flash_ops.flash_attention(make(r(1, 8, 2, 64)), r(1, 8, 2, 64),
                                         r(1, 8, 2, 64))

    def paged(make):
        table = torch.arange(2, dtype=torch.int32, device=device)[None]
        lens = torch.tensor([20], dtype=torch.int32, device=device)
        return paged_ops.paged_attention(make(r(1, 2, 64)), r(2, 16, 2, 64),
                                         r(2, 16, 2, 64), table, lens)

    def ssd_chunk(make):
        return ssd_ops.ssd_chunk(make(r(1, 1, 8, 2, 16)),
                                 r(1, 1, 8, 2).abs(), r(2),
                                 r(1, 1, 8, 1, 8), r(1, 1, 8, 1, 8))

    def ssd(make):
        return ssd_ops.ssd(make(r(1, 8, 2, 16)), r(1, 8, 2).abs(), r(2),
                           r(1, 8, 1, 8), r(1, 8, 1, 8), chunk=4)

    return {"flash_attention": flash, "paged_attention": paged,
            "ssd_chunk": ssd_chunk, "ssd": ssd}


@pytest.mark.parametrize("name", ["flash_attention", "paged_attention",
                                  "ssd_chunk", "ssd"])
def test_wrappers_refuse_autograd_on_cpu(name):
    """A kernel's output on the card has no grad_fn, so every wrapper
    refuses an input that requires grad under grad mode, on the CPU too
    (where its plain version would have kept the gradient): a training
    path that reached a wrapper fails here and not silently on the card.
    Under no_grad, or with inputs that need no grad, it runs."""
    call = _wrapper_calls()[name]
    with pytest.raises(RuntimeError, match="training attention"):
        call(lambda t: t.requires_grad_(True))
    with torch.no_grad():
        call(lambda t: t.requires_grad_(True))
    call(lambda t: t)
