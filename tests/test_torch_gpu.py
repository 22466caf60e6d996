"""The PyTorch port's CUDA kernels on a GPU: each against its plain version,
and the engine's kernel path (bucketed, and chunked + radix) against its CPU
run.  Marked ``gpu``; every test
skips where no CUDA device is visible.  On the card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import FCFSScheduler, Request
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_tiled_ref
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ref import paged_attention_tiled_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_tiled_ref, ssd_ref
from repro_torch.models import DtypePolicy, init_params
from repro_torch.serving import EngineConfig, ServingEngine

pytestmark = pytest.mark.gpu

# kernel vs plain version: the two sum in different orders
TOLS = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# bf16 kernel vs its tiled plain version, which rounds P and the output to
# bf16 as the kernel does: a bf16 ulp (at most 2^-7 of the value) plus f32
# summation order, per element
TILED_ATOL, TILED_RTOL = 1e-3, 1e-2
# bf16 SSD kernel vs ssd_chunk_tiled_ref, which rounds P′ and w∘x to bf16 as
# the kernel does, per element: |d| <= SSD_TILED_ATOL · max|ref| +
# SSD_TILED_RTOL · |ref|.  What is left is f32 summation order, exp2 against
# torch.exp2 and the decay scan's order (cumulative decays reach a few
# thousand, where an f32 ulp is ~2e-4), each of which can also move a
# rounded bf16 operand by one ulp (2^-8 of it).
SSD_TILED_ATOL, SSD_TILED_RTOL = 1e-3, 1e-2
# f32 flash kernel vs flash_attention_tiled_ref(tf32_products=3), per
# element.  Both split the same operands into TF32 big + small and drop the
# same small·small terms, so the split's own error (below 2^-21 of each
# operand) cancels; what is left is f32 accumulation order (about dk·2^-24
# of Σ|q·k| in a score, the tensor cores' adds included) and ex2.approx's 2
# ulp.  Never looser than the f32 limit of 1e-4 against the dense version.
TF32X3_ATOL, TF32X3_RTOL = 1e-5, 1e-4
# f32 SSD kernels vs ssd_chunk_tiled_ref(tf32_products=3), per element: |d|
# <= SSD_TF32X3_ATOL · max|ref| + SSD_TF32X3_RTOL · |ref|.  Both split the
# same operands into TF32 big + small and take the decays from an f64 scan
# rounded once to f32, so what is left is f32 accumulation order (the
# tensor cores' adds included: about 2^-24·√K of the summed magnitudes over
# K <= 256 terms, well under 5e-6 of the scale) and ex2.approx's 2 ulp.
# atol + rtol is a quarter of the f32 limit of 1e-4 of scale against the
# dense version.
SSD_TF32X3_ATOL, SSD_TF32X3_RTOL = 5e-6, 2e-5


def _assert_matches_tiled(out, q, k, v, causal, window):
    ref = flash_attention_tiled_ref(*(t.transpose(1, 2) for t in (q, k, v)),
                                    causal=causal, window=window,
                                    tile=flash_ops.BF16_KV_TILE[q.shape[-1]])
    torch.testing.assert_close(out.float(), ref.transpose(1, 2).float(),
                               atol=TILED_ATOL, rtol=TILED_RTOL)


def _assert_matches_tf32x3(out, q, k, v, **kw):
    """The f32 kernel against the plain version that rounds as it does:
    three TF32 products of split operands, its KV tile."""
    ref = flash_attention_tiled_ref(
        *(t.transpose(1, 2) for t in (q, k, v)), round_p=False,
        tf32_products=3, tile=flash_ops.F32_KV_TILE[q.shape[-1]], **kw)
    torch.testing.assert_close(out, ref.transpose(1, 2), atol=TF32X3_ATOL,
                               rtol=TF32X3_RTOL)


@pytest.fixture(scope="session")
def warm_libraries():
    """Every kernel library built, loaded and launched once (each paged
    kernel in both types) before the first test on the card, so that no
    profiler session sees a library's first load or a kernel's first
    launch: sessions inside pytest have stopped recording device events
    from such a test on (ROADMAP.md section 3)."""
    if not torch.cuda.is_available():
        return
    from repro_torch.kernels import _build
    _build.build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.arange(2, dtype=torch.int32, device=dev)[None]
    lens = torch.tensor([20], dtype=torch.int32, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((1, 64, 2, 64), generator=g, device=dev).to(dtype)
        flash_ops.flash_attention(x, x, x)
        kp = torch.randn((2, 16, 2, 64), generator=g, device=dev).to(dtype)
        for H in (2, 4):               # G = 1 and a group of 2
            q = torch.randn((1, H, 64), generator=g, device=dev).to(dtype)
            paged_ops.paged_attention(q, kp, kp, table, lens)
        x, dt, A_log, B, C = _ssd_inputs(g, dev, 1, 20, 4, 16, 4, 16, dtype)
        ssd_ops.ssd_chunk(x.view(1, 1, 20, 4, 16), dt.view(1, 1, 20, 4),
                          A_log, B.view(1, 1, 20, 4, 16),
                          C.view(1, 1, 20, 4, 16))
    torch.cuda.synchronize()


@pytest.fixture
def cuda(warm_libraries):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,hd,causal,window", [
    (1, 128, 2, 2, 128, True, 0),
    (2, 256, 4, 2, 128, True, 0),       # GQA
    (1, 256, 4, 1, 64, True, 0),        # MQA, hd 64
    (1, 256, 2, 2, 128, True, 64),      # sliding window
    (2, 128, 4, 4, 128, False, 0),      # bidirectional
    (1, 77, 2, 2, 128, True, 30),       # ragged S
    (1, 300, 8, 2, 80, True, 0),        # h2o-danube's hd 80 (G = 4)
    (1, 300, 8, 2, 80, True, 64),
    (2, 130, 32, 8, 80, True, 4096),    # its heads and window
    (1, 300, 4, 2, 256, True, 0),       # gemma3's hd 256 (G = 2)
    (1, 300, 4, 2, 256, True, 100),
    (1, 1100, 8, 4, 256, True, 1024),   # its heads and local window
])
def test_flash_kernel_matches_plain(cuda, dtype, B, S, H, K, hd, causal,
                                    window):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((B, S, n, hd), generator=g, device=cuda).to(dtype)
               for n in (H, K, K))
    before = flash_ops.KERNEL.launches
    out = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    ref = flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                    impl="plain")
    assert flash_ops.KERNEL.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=TOLS[dtype],
                               rtol=TOLS[dtype])
    if dtype == torch.bfloat16:
        _assert_matches_tiled(out, q, k, v, causal, window)
    else:
        _assert_matches_tf32x3(out, q, k, v, causal=causal, window=window)


@pytest.mark.parametrize("dk,dv", flash_ops.HEAD_DIMS)
def test_flash_routes_by_type(cuda, dk, dv):
    """At every head width, f32 runs the 3xTF32 tensor-core kernel alone and
    bf16 the bf16 one alone (profiler names): no CUDA-core kernel, no plain
    version."""
    g = torch.Generator(device=cuda).manual_seed(4)
    for dtype, want in ((torch.float32, {"flash_fwd_tf32x3_kernel"}),
                        (torch.bfloat16, {"flash_fwd_wgmma_kernel"})):
        q, k = (torch.randn((1, 130, 4, dk), generator=g, device=cuda)
                .to(dtype) for _ in range(2))
        v = torch.randn((1, 130, 4, dv), generator=g, device=cuda).to(dtype)
        flash_ops.flash_attention(q, k, v)          # built and loaded before
        before = flash_ops.KERNEL.launches
        assert _device_kernels(lambda: flash_ops.flash_attention(q, k, v)) \
            == want
        assert flash_ops.KERNEL.launches == before + 1


@pytest.mark.parametrize("bits", [0x7FC00000, 0x7FFFFFFF, -1])
@pytest.mark.parametrize("where", ["q", "k", "v"])
def test_flash_f32_propagates_nan(cuda, where, bits):
    """A NaN in q, k or v (quiet, the card's canonical 0x7fffffff, and a
    negative one) reaches every output row that reads it, as in the plain
    version: the TF32 split keeps it in the small part.  q at row t: row t
    alone; k at key t: the rows that see it (t and after); v at key t: at
    least those rows (the plain version's 0·NaN spreads it to all)."""
    g = torch.Generator(device=cuda).manual_seed(6)
    S, t = 150, 70
    q, k, v = (torch.randn((1, S, 2, 128), generator=g, device=cuda)
               for _ in range(3))
    {"q": q, "k": k, "v": v}[where].view(torch.int32)[0, t, 0, 5] = bits
    out = flash_ops.flash_attention(q, k, v)
    ref = flash_ops.flash_attention(q, k, v, impl="plain")
    rows = out[0, :, 0].isnan().any(-1)
    assert not out[0, :, 1].isnan().any()            # the other head
    after = torch.arange(S, device=cuda) >= t
    if where == "v":
        assert rows[after].all()
    else:
        assert torch.equal(rows, ref[0, :, 0].isnan().any(-1))
        assert torch.equal(rows, after if where == "k"
                           else torch.arange(S, device=cuda) == t)


@pytest.mark.parametrize("B,S,T,H,K,hd,causal,window", [
    *[(2, S, S, 8, 2, hd, True, 0)                      # G = 4, ragged S
      for S in (1, 63, 65, 1000, 2048) for hd in (64, 128)],
    (1, 300, 300, 16, 2, 128, True, 0),                 # G = 8
    (1, 1000, 1000, 8, 8, 128, True, 256),              # window 256
    (1, 700, 700, 4, 1, 64, True, 256),
    (2, 100, 300, 4, 2, 128, False, 0),                 # bidirectional, T > S
    (1, 300, 100, 4, 4, 64, False, 0),                  # bidirectional, T < S
])
def test_flash_bf16_tensor_core_kernel(cuda, B, S, T, H, K, hd, causal,
                                       window):
    """The bf16 tensor-core kernel at ragged lengths (a single row, one
    either side of a 64-row warpgroup's rows), both head dims, GQA groups
    of 4 and 8,
    a sliding window and T != S, against the dense and the tiled plain
    versions; one counted launch per call."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((B, S, H, hd), generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((B, T, K, hd), generator=g, device=cuda).bfloat16()
            for _ in range(2))
    before = flash_ops.KERNEL.launches
    out = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    assert flash_ops.KERNEL.launches == before + 1
    ref = flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                    impl="plain")
    assert flash_ops.KERNEL.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=3e-2)
    _assert_matches_tiled(out, q, k, v, causal, window)


# ---- bf16 flash on wgmma fed by TMA: every (dk, dv), each case on three
# seeds, per element against the tiled plain version at the kernel's tile --

FLASH_SEEDS = (0, 1, 2)


def _bf16_flash_inputs(cuda, seed, B, S, T, H, K, dk, dv):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((B, S, H, dk), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, T, K, dk), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, T, K, dv), generator=g, device=cuda).bfloat16()
    return q, k, v


def _assert_bf16_flash(q, k, v, **kw):
    """One counted launch of the bf16 kernel, within 3e-2 of the dense
    plain version and, per element, within TILED_ATOL + TILED_RTOL·|ref| of
    the tiled one at ``BF16_KV_TILE``; returns the kernel's output."""
    before = flash_ops.KERNEL.launches
    out = flash_ops.flash_attention(q, k, v, **kw)
    assert flash_ops.KERNEL.launches == before + 1
    assert out.dtype == torch.bfloat16
    assert out.shape == q.shape[:3] + (v.shape[3],)
    dense = flash_ops.flash_attention(q, k, v, impl="plain", **kw)
    torch.testing.assert_close(out.float(), dense.float(), atol=3e-2,
                               rtol=3e-2)
    tiled = flash_attention_tiled_ref(
        *(t.transpose(1, 2) for t in (q, k, v)), **kw,
        tile=flash_ops.BF16_KV_TILE[q.shape[-1]]).transpose(1, 2)
    torch.testing.assert_close(out.float(), tiled.float(), atol=TILED_ATOL,
                               rtol=TILED_RTOL)
    return out


@pytest.mark.parametrize("G", [1, 4, 8, 16])
@pytest.mark.parametrize("dk,dv", flash_ops.HEAD_DIMS)
def test_flash_wgmma_groups(cuda, dk, dv, G):
    """Every (dk, dv) at GQA groups of 1, 4, 8 and 16 (two KV heads),
    causal, S = T = 300 (a ragged third query tile)."""
    for seed in FLASH_SEEDS:
        q, k, v = _bf16_flash_inputs(cuda, seed, 1, 300, 300, 2 * G, 2, dk,
                                     dv)
        _assert_bf16_flash(q, k, v)


@pytest.mark.parametrize("mode", ["offset", "window", "bidirectional"])
@pytest.mark.parametrize("S", [1, 130, 1000])
@pytest.mark.parametrize("dk,dv", flash_ops.HEAD_DIMS)
def test_flash_wgmma_lengths_and_masks(cuda, dk, dv, S, mode):
    """Every (dk, dv) at S = 1, 130 and 1000 queries with T != S: a chunk at
    a query offset over the first kv_len rows of a longer cache, a sliding
    window at an offset, and bidirectional attention over more keys than
    queries (G = 2)."""
    kw, T = {
        "offset": (dict(q_offset=77, kv_len=S + 77), S + 97),
        "window": (dict(q_offset=30, window=100), S + 30),
        "bidirectional": (dict(causal=False), S + 50),
    }[mode]
    for seed in FLASH_SEEDS:
        q, k, v = _bf16_flash_inputs(cuda, seed, 2, S, T, 4, 2, dk, dv)
        _assert_bf16_flash(q, k, v, **kw)


@pytest.mark.parametrize("dk,dv", flash_ops.HEAD_DIMS)
def test_flash_wgmma_fully_masked_rows_give_zero(cuda, dk, dv):
    """Queries at positions 250..379 over the first 300 keys with a window
    of 64: the rows at 363 and after (whose windows start at key 300) see no
    key and give exactly 0, the others hold against the plain versions."""
    kw = dict(q_offset=250, kv_len=300, window=64)
    for seed in FLASH_SEEDS:
        q, k, v = _bf16_flash_inputs(cuda, seed, 1, 130, 320, 4, 2, dk, dv)
        out = _assert_bf16_flash(q, k, v, **kw)
        assert torch.all(out[:, 113:] == 0)
        assert torch.all(out[:, :113].abs().amax(-1) > 0)


@pytest.mark.parametrize("dk,dv", flash_ops.HEAD_DIMS)
def test_flash_wgmma_nan_stays_in_its_head(cuda, dk, dv):
    """A NaN in one query row of query head 1 gives NaN in that row of that
    head alone: every other row and head is finite and holds against the
    tiled plain version."""
    for seed in FLASH_SEEDS:
        q, k, v = _bf16_flash_inputs(cuda, seed, 1, 150, 150, 4, 2, dk, dv)
        q[0, 70, 1, 5] = float("nan")
        out = flash_ops.flash_attention(q, k, v)
        nan_rows = out.isnan().any(-1)
        want = torch.zeros_like(nan_rows)
        want[0, 70, 1] = True
        assert torch.equal(nan_rows, want)
        assert out[0, 70, 1].isnan().all()
        tiled = flash_attention_tiled_ref(
            *(t.transpose(1, 2) for t in (q, k, v)),
            tile=flash_ops.BF16_KV_TILE[dk]).transpose(1, 2)
        keep = ~want
        torch.testing.assert_close(out.float()[keep], tiled.float()[keep],
                                   atol=TILED_ATOL, rtol=TILED_RTOL)


@pytest.mark.parametrize("case", ["chunk", "bidirectional"])
@pytest.mark.parametrize("dk,dv", flash_ops.HEAD_DIMS)
def test_flash_wgmma_reads_no_key_past_kv_len(cuda, dk, dv, case):
    """The rows of k and v at and past kv_len filled with NaN: the output is
    finite and equal to the output with those rows zeroed (the tensor maps
    of k and v end at kv_len, so TMA fills those rows with zeros and never
    reads them).  A chunk of 200 queries at offset 300 over 500 visible
    rows of a 700-row cache, and a bidirectional call over 100 of 256."""
    kw, S, T = {
        "chunk": (dict(q_offset=300, kv_len=500), 200, 700),
        "bidirectional": (dict(causal=False, kv_len=100), 130, 256),
    }[case]
    for seed in FLASH_SEEDS:
        q, k, v = _bf16_flash_inputs(cuda, seed, 2, S, T, 4, 2, dk, dv)
        k[:, kw["kv_len"]:] = 0
        v[:, kw["kv_len"]:] = 0
        zeroed = _assert_bf16_flash(q, k, v, **kw)
        k[:, kw["kv_len"]:] = float("nan")
        v[:, kw["kv_len"]:] = float("nan")
        out = flash_ops.flash_attention(q, k, v, **kw)
        assert bool(torch.isfinite(out).all())
        assert torch.equal(out, zeroed)


@pytest.mark.parametrize("dk,dv", flash_ops.HEAD_DIMS)
def test_flash_wgmma_instances_do_not_spill(cuda, dk, dv):
    """ptxas reports no spill store for any bf16 flash instance."""
    assert _spill_bytes("flash_attention", "flash_fwd_wgmma_kernel", "",
                        (dk, dv)) == 0


def test_flash_tensor_map_encode_cost(cuda):
    """The host cost of one bf16 call's six tensor-map encodes is a few
    microseconds at the main case's shapes."""
    q, k, v = _bf16_flash_inputs(cuda, 0, 2, 1024, 1024, 40, 40, 128, 128)
    us = flash_ops.map_encode_us(q, k, v, iters=200)
    assert 0 < us < 100


def _paged_inputs(rng, g, dev, dtype, lens, H, K, hd, page, npg, shuffle):
    B = len(lens)
    n_pool = B * npg
    q = torch.randn((B, H, hd), generator=g, device=dev).to(dtype)
    kp, vp = (torch.randn((n_pool, page, K, hd), generator=g, device=dev)
              .to(dtype) for _ in range(2))
    table = (rng.permutation(n_pool) if shuffle else np.arange(n_pool))
    bt = torch.tensor(table.reshape(B, npg), dtype=torch.int32, device=dev)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kp, vp, bt, sl


@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_split_boundaries(cuda, dtype, G):
    """Sequence lengths on either side of every 256-token partition edge of
    a 1024-token table (4 partitions of the split kernel; G >= 2 walks
    ``GQA_PARTITION``-token ones), through split and merge."""
    p = paged_ops.PARTITION
    lens = [1] + [e * p + d for e in (1, 2, 3) for d in (-1, 0, 1)] + [4 * p]
    q, kp, vp, bt, sl = _paged_inputs(np.random.default_rng(2),
                                      torch.Generator(device=cuda).manual_seed(2),
                                      cuda, dtype, lens, 2 * G, 2, 128, 16,
                                      4 * p // 16, shuffle=True)
    assert paged_ops.split_count(bt.shape[1], 16) == 4
    before = paged_ops.KERNEL.launches
    out = paged_ops.paged_attention(q, kp, vp, bt, sl)
    assert paged_ops.KERNEL.launches == before + 1
    ref = paged_ops.paged_attention(q, kp, vp, bt, sl, impl="plain")
    torch.testing.assert_close(out.float(), ref.float(), atol=TOLS[dtype],
                               rtol=TOLS[dtype])


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_long_among_short(cuda, dtype, shuffle):
    """The llama2 serve's decode shape: 8 slots of 2048 tokens (H = K = 40,
    hd 128, pages of 16), one 2000-token sequence among seven under 100."""
    lens = [2000, 17, 99, 1, 64, 33, 80, 5]
    q, kp, vp, bt, sl = _paged_inputs(np.random.default_rng(3),
                                      torch.Generator(device=cuda).manual_seed(3),
                                      cuda, dtype, lens, 40, 40, 128, 16, 128,
                                      shuffle)
    before = paged_ops.KERNEL.launches
    out = paged_ops.paged_attention(q, kp, vp, bt, sl)
    assert paged_ops.KERNEL.launches == before + 1
    ref = paged_ops.paged_attention(q, kp, vp, bt, sl, impl="plain")
    torch.testing.assert_close(out.float(), ref.float(), atol=TOLS[dtype],
                               rtol=TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,hd,page,npg,P", [
    (2, 4, 2, 128, 16, 4, 32),
    (3, 8, 1, 128, 8, 6, 64),           # MQA (G = 8)
    (4, 8, 8, 64, 16, 3, 16),
    (8, 32, 8, 80, 16, 128, 1024),      # h2o-danube's hd 80 (G = 4)
    (4, 32, 8, 80, 16, 1, 4),           # one page, one partition
    (8, 8, 4, 256, 16, 128, 1024),      # gemma3's hd 256 (G = 2)
    (4, 8, 4, 256, 16, 1, 4),
])
def test_paged_kernel_matches_plain(cuda, dtype, B, H, K, hd, page, npg, P):
    rng = np.random.default_rng(0)
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((B, H, hd), generator=g, device=cuda).to(dtype)
    kp, vp = (torch.randn((P, page, K, hd), generator=g, device=cuda).to(dtype)
              for _ in range(2))
    bt = torch.tensor(rng.choice(P, (B, npg), replace=False), dtype=torch.int32,
                      device=cuda)
    sl = torch.tensor(rng.integers(1, npg * page + 1, (B,)), dtype=torch.int32,
                      device=cuda)
    before = paged_ops.KERNEL.launches
    out = paged_ops.paged_attention(q, kp, vp, bt, sl)
    ref = paged_ops.paged_attention(q, kp, vp, bt, sl, impl="plain")
    assert paged_ops.KERNEL.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=TOLS[dtype],
                               rtol=TOLS[dtype])
    if H > K:
        _assert_matches_gqa_tiled(out, q, kp, vp, bt, sl)


def _assert_matches_gqa_tiled(out, q, kp, vp, bt, sl):
    """Grouped decode per element against the plain version that walks
    each ``GQA_PARTITION``-token partition in 32-token tiles against the
    tile's max, rounding as the kernel does: bf16 rounds P to bf16, f32
    takes both products as three TF32 products of split operands."""
    if q.dtype == torch.bfloat16:
        tiled = paged_attention_tiled_ref(q, kp, vp, bt, sl,
                                          partition=paged_ops.GQA_PARTITION)
        torch.testing.assert_close(out.float(), tiled.float(),
                                   atol=TILED_ATOL, rtol=TILED_RTOL)
    else:
        tiled = paged_attention_tiled_ref(
            q, kp, vp, bt, sl, partition=paged_ops.GQA_PARTITION,
            round_p=False, tf32_products=3)
        torch.testing.assert_close(out, tiled, atol=TF32X3_ATOL,
                                   rtol=TF32X3_RTOL)


@pytest.mark.parametrize("partition", [64, 128, 256])
@pytest.mark.parametrize("G", [2, 4, 8, 16])
@pytest.mark.parametrize("hd", [64, 80, 128, 256])
def test_paged_gqa_mma_kernel_matches_plain(cuda, monkeypatch, hd, G,
                                            partition):
    """bf16 with G >= 2 query heads a KV head (``paged_gqa_mma_kernel``)
    at every width and group and each partition size timed on the card:
    one token, lengths on both sides of the 32-token tile edges and of the
    partition edges, a full table; two KV heads, a shuffled table.  Within
    the bf16 limit of the dense plain version and, per element, of the
    tiled one; one counted launch."""
    monkeypatch.setattr(paged_ops, "GQA_PARTITION", partition)
    P = partition
    lens = [1, 31, 32, 33, P - 1, P, P + 1, 2 * P + 17, 3 * P]
    q, kp, vp, bt, sl = _paged_inputs(
        np.random.default_rng(hd + G), torch.Generator(device=cuda).manual_seed(
            hd + G), cuda, torch.bfloat16, lens, 2 * G, 2, hd, 16,
        3 * P // 16, shuffle=True)
    assert bt.shape[1] * 16 == 3 * P           # three partitions
    before = paged_ops.KERNEL.launches
    out = paged_ops.paged_attention(q, kp, vp, bt, sl)
    assert paged_ops.KERNEL.launches == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    ref = paged_ops.paged_attention(q, kp, vp, bt, sl, impl="plain")
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2,
                               rtol=3e-2)
    _assert_matches_gqa_tiled(out, q, kp, vp, bt, sl)


@pytest.mark.parametrize("partition", [64, 128, 256])
@pytest.mark.parametrize("G", [2, 4, 8, 16])
@pytest.mark.parametrize("hd", [64, 80, 128, 256])
def test_paged_gqa_tf32x3_kernel_matches_plain(cuda, monkeypatch, hd, G,
                                               partition):
    """f32 with G >= 2 query heads a KV head (``paged_gqa_tf32x3_kernel``)
    at every width and group and each partition size timed on the card:
    one token, lengths on both sides of the 32-token tile edges and of the
    partition edges, a full table; two KV heads, a shuffled table.  Within
    the f32 limit (1e-4) of the dense plain version and, per element,
    within TF32X3_ATOL + TF32X3_RTOL·|ref| of the 3xTF32 tiled one; one
    counted launch."""
    monkeypatch.setattr(paged_ops, "GQA_PARTITION", partition)
    P = partition
    lens = [1, 31, 32, 33, P - 1, P, P + 1, 2 * P + 17, 3 * P]
    q, kp, vp, bt, sl = _paged_inputs(
        np.random.default_rng(hd + G + 1), torch.Generator(
            device=cuda).manual_seed(hd + G + 1), cuda, torch.float32, lens,
        2 * G, 2, hd, 16, 3 * P // 16, shuffle=True)
    assert bt.shape[1] * 16 == 3 * P           # three partitions
    before = paged_ops.KERNEL.launches
    out = paged_ops.paged_attention(q, kp, vp, bt, sl)
    assert paged_ops.KERNEL.launches == before + 1
    assert out.shape == q.shape and out.dtype == torch.float32
    ref = paged_ops.paged_attention(q, kp, vp, bt, sl, impl="plain")
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    _assert_matches_gqa_tiled(out, q, kp, vp, bt, sl)


@pytest.mark.parametrize("dtype,G,merged,kernel", [
    (torch.bfloat16, 2, False, "paged_gqa_mma_kernel"),
    (torch.bfloat16, 16, True, "paged_gqa_mma_kernel"),
    (torch.bfloat16, 1, True, "paged_split_kernel"),
    (torch.float32, 1, True, "paged_split_kernel"),
    (torch.float32, 2, False, "paged_gqa_tf32x3_kernel"),
    (torch.float32, 4, True, "paged_gqa_tf32x3_kernel"),
    (torch.float32, 16, True, "paged_gqa_tf32x3_kernel"),
])
def test_paged_routes_by_type_and_group(cuda, dtype, G, merged, kernel):
    """G >= 2 runs ``paged_gqa_mma_kernel`` in bf16 and
    ``paged_gqa_tf32x3_kernel`` in f32, G = 1 ``paged_split_kernel`` in
    both, then the merge where the table spans more than one partition,
    and nothing else."""
    lens, npg = ([5, 300, 2000], 128) if merged else ([5, 17, 32], 2)
    q, kp, vp, bt, sl = _paged_inputs(
        np.random.default_rng(G), torch.Generator(device=cuda).manual_seed(G),
        cuda, dtype, lens, G, 1, 256, 16, npg, shuffle=False)
    partition = paged_ops.partition_for(256, 256, G, dtype)
    assert (npg * 16 > partition) == merged

    def call():
        return paged_ops.paged_attention(q, kp, vp, bt, sl)
    call()                              # built and loaded before
    assert _device_kernels(call) == ({kernel, "paged_merge_kernel"} if merged
                                     else {kernel})


def _internvl2_inputs(cuda, dtype):
    """internvl2-76b's heads, H 64 on K 8 at hd 128 (G = 8): flash inputs
    at S = 300, and paged inputs over 4 slots of 2048 tokens (one long
    among short ones, a shuffled table)."""
    g = torch.Generator(device=cuda).manual_seed(64)
    q, k, v = (torch.randn((1, 300, n, 128), generator=g, device=cuda)
               .to(dtype) for n in (64, 8, 8))
    paged = _paged_inputs(np.random.default_rng(64), g, cuda, dtype,
                          [2000, 17, 300, 1], 64, 8, 128, 16, 128,
                          shuffle=True)
    return (q, k, v), paged


@pytest.mark.parametrize("dtype,flash_kernel,paged_kernel", [
    (torch.bfloat16, "flash_fwd_wgmma_kernel", "paged_gqa_mma_kernel"),
    (torch.float32, "flash_fwd_tf32x3_kernel", "paged_gqa_tf32x3_kernel"),
])
def test_internvl2_heads_route_by_type(cuda, dtype, flash_kernel,
                                       paged_kernel):
    """At internvl2-76b's heads each kernel, called warm, runs alone (with
    the merge for paged) in the profiler's names: bf16 the tensor-core
    kernels, f32 the 3xTF32 ones."""
    (q, k, v), (pq, kp, vp, bt, sl) = _internvl2_inputs(cuda, dtype)

    def flash():
        return flash_ops.flash_attention(q, k, v)

    def paged():
        return paged_ops.paged_attention(pq, kp, vp, bt, sl)
    flash()
    paged()
    assert _device_kernels(flash) == {flash_kernel}
    assert _device_kernels(paged) == {paged_kernel, "paged_merge_kernel"}


def _ssd_inputs(g, dev, b, s, H, P, G, N, dtype):
    x = (torch.randn((b, s, H, P), generator=g, device=dev) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, s, H), generator=g,
                                                  device=dev))
    A_log = torch.log(torch.linspace(1.0, 16.0, H, device=dev))
    B, C = ((torch.randn((b, s, G, N), generator=g, device=dev) * 0.3).to(dtype)
            for _ in range(2))
    return x, dt, A_log, B, C


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nc,Q,H,P,G,N", [
    (2, 2, 256, 4, 64, 1, 128),         # the mamba2-370m widths
    (1, 3, 100, 4, 32, 2, 64),          # Q not a multiple of the tile, groups
    (1, 1, 20, 4, 16, 4, 16),           # Q below one tile, G = H
    (1, 2, 64, 2, 128, 1, 256),
    (1, 2, 256, 32, 64, 1, 128),        # mamba2-370m's 32 heads in one group
    (1, 2, 192, 6, 64, 2, 64),          # H / G = 3: slabs of 3 heads
    (2, 1, 150, 4, 32, 2, 24),          # N = 24, not a multiple of 16
    (1, 2, 130, 4, 64, 1, 256),         # N = 256 at P = 64, ragged Q
    (1, 1, 256, 16, 16, 1, 64),         # P = 16: a slab of 16 heads
    (1, 2, 77, 2, 128, 2, 128),         # P = 128, one head a slab, ragged Q
    (1, 1, 128, 5, 32, 1, 32),          # H / G = 5: slabs of 5 heads
    (1, 1, 1024, 16, 16, 1, 128),       # a slab of 16 over shared memory
    (1, 1, 768, 16, 16, 1, 256),        # the widest f32 slab that fits
])
def test_ssd_chunk_kernel_matches_plain(cuda, dtype, b, nc, Q, H, P, G, N):
    g = torch.Generator(device=cuda).manual_seed(0)
    x, dt, A_log, B, C = _ssd_inputs(g, cuda, b, nc * Q, H, P, G, N, dtype)
    args = (x.view(b, nc, Q, H, P), dt.view(b, nc, Q, H), A_log,
            B.view(b, nc, Q, G, N), C.view(b, nc, Q, G, N))
    before = ssd_ops.KERNEL.launches
    out = ssd_ops.ssd_chunk(*args)
    ref = ssd_ops.ssd_chunk(*args, impl="plain")
    torch.cuda.synchronize()
    assert ssd_ops.KERNEL.launches == before + 1
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32 and o.shape == r.shape
        # relative to the output's scale: the two sum in different orders
        err = float((o - r).abs().max() / r.abs().max().clamp_min(1e-30))
        assert err <= TOLS[dtype], err
    if dtype == torch.bfloat16:
        tiled, atol, rtol = ssd_chunk_tiled_ref(*args), SSD_TILED_ATOL, \
            SSD_TILED_RTOL
    else:
        tiled = ssd_chunk_tiled_ref(*args, round=False, tf32_products=3)
        atol, rtol = SSD_TF32X3_ATOL, SSD_TF32X3_RTOL
    for o, r in zip(out, tiled):
        torch.testing.assert_close(o, r, rtol=rtol,
                                   atol=atol * float(r.abs().max()))


@pytest.mark.parametrize("bits", [0x7FC00000, 0x7FFFFFFF, -1])
@pytest.mark.parametrize("P,N", [(64, 128), (16, 256)])
def test_ssd_chunk_f32_propagates_nan(cuda, P, N, bits):
    """A NaN in x (quiet, the card's canonical 0x7fffffff, and a negative
    one) reaches every y row at or after its position in its head and
    column, and its head's chunk-end state column, and no other column,
    head or chunk: the TF32 split keeps it in the small part.  (Rows before
    it may be NaN too, as in the dense product, where a masked score is a 0
    times the NaN.)"""
    g = torch.Generator(device=cuda).manual_seed(4)
    b, nc, Q, H, G = 1, 2, 200, 4, 1
    x, dt, A_log, B, C = _ssd_inputs(g, cuda, b, nc * Q, H, P, G, N,
                                     torch.float32)
    x = x.view(b, nc, Q, H, P)
    q, h, p = 70, 2, 5
    x.view(torch.int32)[0, 1, q, h, p] = bits
    y, states, _, _ = ssd_ops.ssd_chunk(x, dt.view(b, nc, Q, H), A_log,
                                        B.view(b, nc, Q, G, N),
                                        C.view(b, nc, Q, G, N))
    torch.cuda.synchronize()
    assert bool(y[0, 1, q:, h, p].isnan().all())
    assert bool(states[0, 1, h, :, p].isnan().all())
    y[0, 1, :, h, p] = 0.0
    states[0, 1, h, :, p] = 0.0
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(states).all())


def test_ssd_chunk_refuses_too_long_chunk(cuda):
    """A chunk over MAX_CHUNK is refused before launch, with its length
    named; MAX_CHUNK itself runs at the widest head and state."""
    g = torch.Generator(device=cuda).manual_seed(5)
    for Q, ok in ((ssd_ops.MAX_CHUNK, True), (ssd_ops.MAX_CHUNK + 1, False)):
        x, dt, A_log, B, C = _ssd_inputs(g, cuda, 1, Q, 1, 128, 1, 256,
                                         torch.float32)
        args = (x.view(1, 1, Q, 1, 128), dt.view(1, 1, Q, 1), A_log,
                B.view(1, 1, Q, 1, 256), C.view(1, 1, Q, 1, 256))
        if ok:
            y = ssd_ops.ssd_chunk(*args)[0]
            torch.cuda.synchronize()
            assert bool(torch.isfinite(y).all())
        else:
            with pytest.raises(ValueError, match=str(Q)):
                ssd_ops.ssd_chunk(*args)


def _device_kernels(fn) -> set:
    """Names of the device kernels one call of ``fn`` ran, by the
    profiler (namespace, template arguments and parameters dropped)."""
    from torch.profiler import ProfilerActivity, profile
    # Keep CUPTI initialized from one session to the next: with its
    # teardown after each session, some later sessions recorded no device
    # event at all (chip_smoke.py::launched_kernels does the same).
    os.environ["TEARDOWN_CUPTI"] = "0"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = set()
    for ev in prof.key_averages():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and ev.self_device_time_total > 0):
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0].split("<")[0]
            names.add(name.split("::")[-1])
    return names


def test_ssd_chunk_kernel_routes_by_type(cuda):
    """bf16 runs its two tensor-core kernels alone, f32 its two 3xTF32
    tensor-core kernels alone."""
    g = torch.Generator(device=cuda).manual_seed(3)
    b, nc, Q, H, P, G, N = 1, 2, 256, 8, 64, 1, 128
    ran = {}
    for dtype in (torch.bfloat16, torch.float32):
        x, dt, A_log, B, C = _ssd_inputs(g, cuda, b, nc * Q, H, P, G, N, dtype)
        args = (x.view(b, nc, Q, H, P), dt.view(b, nc, Q, H), A_log,
                B.view(b, nc, Q, G, N), C.view(b, nc, Q, G, N))
        ssd_ops.ssd_chunk(*args)            # built and loaded before
        ran[dtype] = _device_kernels(lambda: ssd_ops.ssd_chunk(*args))
    assert ran[torch.bfloat16] == {"ssd_chunk_y_mma_kernel",
                                   "ssd_chunk_state_mma_kernel"}
    assert ran[torch.float32] == {"ssd_chunk_y_tf32x3_kernel",
                                  "ssd_chunk_state_tf32x3_kernel"}


@pytest.mark.parametrize("s,chunk", [(1000, 256), (200, 256), (512, 128)])
def test_ssd_kernel_path_matches_recurrence(cuda, s, chunk):
    """The whole scan through the kernel (padded to whole chunks with
    dt = 0) against the sequential recurrence, output and final state."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x, dt, A_log, B, C = _ssd_inputs(g, cuda, 2, s, 4, 64, 1, 128,
                                     torch.float32)
    before = ssd_ops.KERNEL.launches
    y, h = ssd_ops.ssd(x, dt, A_log, B, C, chunk=chunk)
    assert ssd_ops.KERNEL.launches == before + 1
    yr, hr = ssd_ref(x, dt, A_log, B, C)
    assert float((y - yr).abs().max() / yr.abs().max()) <= 1e-4
    assert float((h - hr).abs().max() / hr.abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,T,q_offset,kv_len,H,K,hd,window", [
    (512, 2048, 1024, 1536, 8, 8, 128, 0),   # a suffix chunk after a prefix
    (1, 2048, 1500, 1501, 8, 2, 128, 0),     # a chunk of one token
    (200, 2048, 1500, 1700, 8, 2, 64, 0),    # C not a multiple of the tile
    (300, 1024, 700, 1000, 4, 4, 128, 256),  # window
    (63, 256, 64, 127, 4, 1, 64, 0),         # MQA, one row short of a tile
    (16, 128, 0, 16, 2, 2, 128, 0),          # first chunk, cache longer
    (1000, 1280, 0, 1000, 8, 2, 128, 0),     # ragged S, GQA, no offset
    (77, 160, 0, 77, 4, 4, 64, 30),          # ragged S, window
    (33, 512, 300, 333, 8, 1, 128, 100),     # MQA, window, at an offset
    (1, 64, 40, 41, 4, 2, 64, 8),            # one token, window, hd 64
])
def test_flash_offset_kernel_matches_plain(cuda, dtype, C, T, q_offset,
                                           kv_len, H, K, hd, window):
    """Chunked-prefill attention: C queries at ``q_offset`` against the
    first ``kv_len`` keys of a longer cache whose other rows hold NaN
    (never read), against both plain versions; one counted launch, one
    offset launch when ``q_offset > 0`` and one window launch when
    ``window > 0``."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((1, C, H, hd), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((1, T, K, hd), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    k[:, kv_len:] = float("nan")
    v[:, kv_len:] = float("nan")
    kw = dict(window=window, q_offset=q_offset, kv_len=kv_len)
    before = flash_ops.KERNEL.launches
    off_before = flash_ops.KERNEL.offset_launches
    win_before = flash_ops.KERNEL.window_launches
    out = flash_ops.flash_attention(q, k, v, **kw)
    ref = flash_ops.flash_attention(q, k, v, impl="plain", **kw)
    assert flash_ops.KERNEL.launches == before + 1
    assert flash_ops.KERNEL.offset_launches == off_before + (q_offset > 0)
    assert flash_ops.KERNEL.window_launches == win_before + (window > 0)
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOLS[dtype],
                               rtol=TOLS[dtype])
    if dtype == torch.bfloat16:
        tiled = flash_attention_tiled_ref(
            *(t.transpose(1, 2) for t in (q, k, v)), **kw,
            tile=flash_ops.BF16_KV_TILE[q.shape[-1]]).transpose(1, 2)
        torch.testing.assert_close(out.float(), tiled.float(),
                                   atol=TILED_ATOL, rtol=TILED_RTOL)
    else:
        _assert_matches_tf32x3(out, q, k, v, **kw)


def _small_cfg():
    return ModelConfig(name="gpu-small", family="dense", n_layers=2,
                       d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
                       vocab_size=512, head_dim=64)


def test_chunk_step_in_pieces_matches_prefill_on_card(cuda):
    """A small model's prompt through chunk_step in chunks of 64, 64 and 29
    on the card (flash with a query offset over the slot cache) gives the
    logits and K/V of one prefill on the card, and of the CPU run."""
    from repro_torch.models import chunk_step, init_decode_caches, prefill
    cfg = _small_cfg()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    pol = DtypePolicy(torch.float32, torch.float32, torch.float32)
    toks = torch.tensor(np.random.default_rng(3).integers(0, 512, (1, 157)))
    got = {}
    for dev in ("cpu", cuda):
        p = params.to(dev)
        ref, ref_c = prefill(p, {"tokens": toks.to(dev)}, cfg, policy=pol)
        caches = init_decode_caches(cfg, 1, 256, dtype=torch.float32,
                                    device=dev)
        pos, off0 = 0, flash_ops.KERNEL.offset_launches
        for w in (64, 64, 29):
            logits, caches = chunk_step(p, toks[:, pos:pos + w].to(dev),
                                        caches, pos, cfg, policy=pol)
            pos += w
        if dev == cuda:
            assert flash_ops.KERNEL.offset_launches == off0 + 2 * 2
        torch.testing.assert_close(logits, ref, atol=1e-4, rtol=1e-4)
        for layer, r in zip(caches, ref_c):
            torch.testing.assert_close(layer["k"][:, :157], r["k"],
                                       atol=1e-4, rtol=1e-4)
        got[str(dev)] = logits.cpu()
    torch.testing.assert_close(got["cuda"], got["cpu"], atol=1e-4, rtol=1e-4)


def test_chunked_radix_engine_kernel_path_matches_cpu_run(cuda):
    """The small model served on the card in chunked + radix mode over
    shared-prefix requests gives the CPU run's greedy tokens and attached
    prefixes, with flash launched at a query offset."""
    cfg = _small_cfg()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    pol = DtypePolicy(torch.float32, torch.float32, torch.float32)
    rng = np.random.default_rng(4)
    prefix = rng.integers(0, 512, size=(64,)).astype(np.int32)
    specs = [(np.concatenate([prefix, rng.integers(0, 512, size=(int(n),))
                              .astype(np.int32)]), int(m))
             for n, m in zip(rng.integers(5, 60, 10), rng.integers(2, 8, 10))]
    outs, cached = {}, {}
    for dev in ("cpu", cuda):
        reqs = [Request(prompt_len=len(t), arrival_time=0.0,
                        max_new_tokens=m, prompt_tokens=t.copy(),
                        request_id=90_000 + i) for i, (t, m) in enumerate(specs)]
        eng = ServingEngine(cfg, params.to(dev), FCFSScheduler(),
                            EngineConfig(max_slots=4, s_max=256,
                                         kv_pool_tokens=4096,
                                         chunk_prefill_tokens=48,
                                         enable_prefix_cache=True),
                            policy=pol, device=dev)
        off0 = flash_ops.KERNEL.offset_launches
        assert len(eng.run(reqs)) == len(reqs)
        if dev == cuda:
            assert flash_ops.KERNEL.offset_launches > off0
        eng.radix.check_invariants()
        outs[str(dev)] = eng.output_tokens
        cached[str(dev)] = {r.request_id: r.cached_len for r in eng.finished}
    assert outs["cpu"] == outs["cuda"]
    assert cached["cpu"] == cached["cuda"]
    assert sum(c > 0 for c in cached["cuda"].values()) >= 4


def test_kernel_wrappers_refuse_what_they_cannot_take(cuda):
    q = torch.zeros((1, 16, 2, 32), device=cuda)          # head_dim 32
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q, q, q)
    q = torch.zeros((1, 16, 2, 64), device=cuda)
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q, q.half(), q)
    kp = torch.zeros((2, 8, 2, 64), device=cuda)
    with pytest.raises(ValueError):                      # int64 block table
        paged_ops.paged_attention(q[:, 0], kp, kp,
                                  torch.zeros((1, 2), dtype=torch.long,
                                              device=cuda),
                                  torch.ones((1,), dtype=torch.int32,
                                             device=cuda))
    x = torch.zeros((1, 1, 16, 2, 48), device=cuda)      # head_dim 48
    bc = torch.zeros((1, 1, 16, 1, 16), device=cuda)
    dt = torch.zeros((1, 1, 16, 2), device=cuda)
    with pytest.raises(ValueError):
        ssd_ops.ssd_chunk(x, dt, torch.zeros(2, device=cuda), bc, bc)
    with pytest.raises(ValueError):                      # bf16 dt
        ssd_ops.ssd_chunk(x[..., :32], dt.bfloat16(),
                          torch.zeros(2, device=cuda), bc, bc)


def test_engine_kernel_path_matches_cpu_run(cuda):
    """A small model (head_dim 64) served on the card through both kernels
    gives the greedy tokens of the same weights served on the CPU."""
    cfg = _small_cfg()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    pol = DtypePolicy(torch.float32, torch.float32, torch.float32)
    outs = {}
    for dev in ("cpu", cuda):
        rng = np.random.default_rng(1)
        reqs = [Request(prompt_len=int(rng.integers(5, 60)), arrival_time=0.0,
                        max_new_tokens=int(rng.integers(2, 8)),
                        request_id=70_000 + i) for i in range(8)]
        eng = ServingEngine(cfg, params.to(dev), FCFSScheduler(),
                            EngineConfig(max_slots=4, s_max=128,
                                         kv_pool_tokens=2048,
                                         buckets=(32, 64)),
                            policy=pol, device=dev)
        flash0, paged0 = flash_ops.KERNEL.launches, paged_ops.KERNEL.launches
        assert len(eng.run(reqs)) == len(reqs)
        if dev == cuda:
            assert flash_ops.KERNEL.launches > flash0
            assert paged_ops.KERNEL.launches > paged0
        outs[str(dev)] = eng.output_tokens
    assert outs["cpu"] == outs["cuda"]


def test_ssm_engine_kernel_path_matches_cpu_run(cuda):
    """The mamba2 smoke config served on the card through the SSD kernel
    (mixed prompt lengths, some above the 32-token chunk and not a multiple
    of it) gives the greedy tokens of the same weights served on the CPU."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("mamba2-370m")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    pol = DtypePolicy(torch.float32, torch.float32, torch.float32)
    outs = {}
    for dev in ("cpu", cuda):
        rng = np.random.default_rng(2)
        reqs = [Request(prompt_len=int(rng.integers(5, 90)), arrival_time=0.0,
                        max_new_tokens=int(rng.integers(2, 8)),
                        request_id=80_000 + i) for i in range(8)]
        eng = ServingEngine(cfg, params.to(dev), FCFSScheduler(),
                            EngineConfig(max_slots=4, s_max=128,
                                         kv_pool_tokens=2048),
                            policy=pol, device=dev)
        ssd0 = ssd_ops.KERNEL.launches
        assert len(eng.run(reqs)) == len(reqs)
        if dev == cuda:
            assert ssd_ops.KERNEL.launches > ssd0
        outs[str(dev)] = eng.output_tokens
    assert outs["cpu"] == outs["cuda"]


def test_two_engine_fleet_on_card_matches_cpu_run(cuda):
    """Two chunked + radix engines of the small model, sharing one set of
    weights behind ``EngineFleet`` (EWSJF router, prefix directory, link
    topology), serve one shared-prefix burst on the card and on the CPU in
    f32: the same dispatch log on each engine and the same greedy
    tokens, with both attention kernels launched on the card."""
    from repro_torch.cluster import EngineFleet, HealthMonitor
    from repro_torch.core import CostModel
    from repro_torch.kvplane import (LinkTopology, PrefixDirectory,
                                     PrefixDirectoryConfig)
    cfg = _small_cfg()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    pol = DtypePolicy(torch.float32, torch.float32, torch.float32)
    rng = np.random.default_rng(6)
    prefix = rng.integers(0, 512, size=(64,)).astype(np.int32)
    specs = [(np.concatenate([prefix if i % 2 else
                              rng.integers(0, 512, size=(64,)).astype(np.int32),
                              rng.integers(0, 512, size=(int(n),))
                              .astype(np.int32)]), int(m))
             for i, (n, m) in enumerate(zip(rng.integers(5, 60, 12),
                                            rng.integers(2, 8, 12)))]
    logs, outs = {}, {}
    for dev in ("cpu", cuda):
        p = params.to(dev)
        engines = [ServingEngine(cfg, p, FCFSScheduler(),
                                 EngineConfig(max_slots=4, s_max=256,
                                              kv_pool_tokens=4096,
                                              chunk_prefill_tokens=48,
                                              enable_prefix_cache=True,
                                              engine_id=i),
                                 policy=pol, device=dev) for i in range(2)]
        fleet = EngineFleet(
            engines, cost=CostModel(), monitor=HealthMonitor(),
            directory=PrefixDirectory(PrefixDirectoryConfig(
                sync_interval=0.0)),
            topology=LinkTopology(), calibrated_routing=False)
        reqs = [Request(prompt_len=len(t), arrival_time=0.0,
                        max_new_tokens=m, prompt_tokens=t.copy(),
                        request_id=95_000 + i)
                for i, (t, m) in enumerate(specs)]
        flash0, paged0 = flash_ops.KERNEL.launches, paged_ops.KERNEL.launches
        res = fleet.serve(reqs, max_ticks=4000)
        assert res["finished"] == len(reqs)
        if dev == cuda:
            assert flash_ops.KERNEL.launches > flash0
            assert paged_ops.KERNEL.launches > paged0
        for e in engines:
            e.radix.check_invariants()
        logs[str(dev)] = [rep.dispatch_order() for rep in fleet.replicas]
        outs[str(dev)] = {rid: t for e in engines
                          for rid, t in e.output_tokens.items()}
    assert all(logs["cuda"])
    assert logs["cpu"] == logs["cuda"]
    assert outs["cpu"] == outs["cuda"]


def test_replay_suite_on_card(cuda):
    """``run_suite`` at smoke size (the small model) on the card: every
    scheduler within its
    bound (FCFS and SJF dispatch equal to the DES, EWSJF's rank
    correlation at least TAU_BOUND), every request finished in both
    executors, both attention kernels launched."""
    from repro_torch.serving.replay import replay_ok, run_suite
    flash0, paged0 = flash_ops.KERNEL.launches, paged_ops.KERNEL.launches
    # the llama2 smoke config's head_dim of 16 is below the kernels' 64
    suite = run_suite(n=12, seed=0, cfg=_small_cfg(), device=cuda)
    assert flash_ops.KERNEL.launches > flash0
    assert paged_ops.KERNEL.launches > paged0
    for rep in suite["reports"]:
        assert replay_ok(rep), (rep["scheduler"], rep["dispatch_tau"])
        assert rep["engine_finished"] == rep["n_requests"] == 12
    assert suite["ok"]


# ---- MLA shapes (deepseek-v2-lite): keys wider than values ------------------

MLA_SCALE = 192 ** -0.5        # (hd + rd)^-0.5 of deepseek-v2-lite


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,q_offset,T", [
    (2, 200, 16, 0, 200),        # MLA prefill in MHA form, ragged S
    (1, 1, 16, 0, 1),            # one token
    (1, 70, 4, 100, 256),        # at an offset into a longer cache
])
def test_flash_mla_dims_kernel_matches_plain(cuda, dtype, B, S, H, q_offset,
                                             T):
    """Flash attention at (dk, dv) = (192, 128), H = K, against its plain
    version (and, in bf16, per element against the tiled plain version that
    rounds P as the tensor-core kernel does)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((B, S, H, 192), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, T, H, 192), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, T, H, 128), generator=g, device=cuda).to(dtype)
    kw = dict(scale=MLA_SCALE, q_offset=q_offset, kv_len=q_offset + S)
    before = flash_ops.KERNEL.launches
    out = flash_ops.flash_attention(q, k, v, **kw)
    assert flash_ops.KERNEL.launches == before + 1
    assert out.shape == (B, S, H, 128) and out.dtype == dtype
    ref = flash_ops.flash_attention(q, k, v, impl="plain", **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOLS[dtype],
                               rtol=TOLS[dtype])
    if dtype == torch.bfloat16:
        tiled = flash_attention_tiled_ref(
            *(t.transpose(1, 2) for t in (q, k, v)), **kw,
            tile=flash_ops.BF16_KV_TILE[q.shape[-1]]).transpose(1, 2)
        torch.testing.assert_close(out.float(), tiled.float(),
                                   atol=TILED_ATOL, rtol=TILED_RTOL)
    else:
        _assert_matches_tf32x3(out, q, k, v, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,lens,npg", [
    (16, [1, 17, 127, 128, 129, 600, 2000, 5], 128),   # 16 partitions of 128
    (16, [1, 9, 33, 100], 8),                          # one partition
    (4, [1, 15, 16, 17, 300], 32),
])
def test_paged_mla_kernel_matches_plain(cuda, dtype, G, lens, npg):
    """Absorbed MLA decode: keys of 576, values the view of their rows'
    first 512 columns, one KV head, G query heads; sequences of one token,
    with a partly filled last page, and on both sides of a partition
    edge."""
    rng = np.random.default_rng(6)
    g = torch.Generator(device=cuda).manual_seed(6)
    B, page = len(lens), 16
    n_pool = B * npg
    q = torch.randn((B, G, 576), generator=g, device=cuda).to(dtype)
    kp = torch.randn((n_pool, page, 1, 576), generator=g,
                     device=cuda).to(dtype)
    vp = kp[..., :512]
    bt = torch.tensor(rng.permutation(n_pool).reshape(B, npg),
                      dtype=torch.int32, device=cuda)
    sl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = paged_ops.KERNEL.launches
    out = paged_ops.paged_attention(q, kp, vp, bt, sl, scale=MLA_SCALE)
    assert paged_ops.KERNEL.launches == before + 1
    assert out.shape == (B, G, 512) and out.dtype == dtype
    ref = paged_ops.paged_attention(q, kp, vp, bt, sl, scale=MLA_SCALE,
                                    impl="plain")
    torch.testing.assert_close(out.float(), ref.float(), atol=TOLS[dtype],
                               rtol=TOLS[dtype])
    _assert_matches_mla_tiled(out, q, kp, vp, bt, sl)


def _assert_matches_mla_tiled(out, q, kp, vp, bt, sl):
    """Per element against the plain version that walks each partition in
    32-token tiles and rounds as the kernel of its type does: bf16, P and
    the output rounded to bf16; f32, both products as three TF32 products
    of split operands."""
    if out.dtype == torch.bfloat16:
        tiled = paged_attention_tiled_ref(q, kp, vp, bt, sl,
                                    partition=paged_ops.MLA_PARTITION,
                                    scale=MLA_SCALE)
        torch.testing.assert_close(out.float(), tiled.float(),
                                   atol=TILED_ATOL, rtol=TILED_RTOL)
    else:
        tiled = paged_attention_tiled_ref(q, kp, vp, bt, sl,
                                    partition=paged_ops.MLA_PARTITION,
                                    scale=MLA_SCALE, round_p=False,
                                    tf32_products=3)
        torch.testing.assert_close(out, tiled, atol=TF32X3_ATOL,
                                   rtol=TF32X3_RTOL)


def _mla_inputs(cuda, dtype, G, lens, npg, seed):
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=cuda).manual_seed(seed)
    B, page = len(lens), 16
    n_pool = B * npg
    q = torch.randn((B, G, 576), generator=g, device=cuda).to(dtype)
    kp = torch.randn((n_pool, page, 1, 576), generator=g,
                     device=cuda).to(dtype)
    bt = torch.tensor(rng.permutation(n_pool).reshape(B, npg),
                      dtype=torch.int32, device=cuda)
    sl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    return q, kp, kp[..., :512], bt, sl


@pytest.mark.parametrize("partition", [64, 128])
@pytest.mark.parametrize("G,lens,npg", [
    (16, [1, 63, 64, 65, 127, 128, 129, 2048], 128),   # the serve's slots
    (16, [1, 9, 32, 31, 30, 5, 17, 2], 2),             # one partition
    (4, [1, 15, 16, 17, 300, 191, 192, 193], 20),
])
def test_paged_mla_bf16_tensor_core_kernel(cuda, monkeypatch, partition, G,
                                           lens, npg):
    """bf16 MLA decode at each partition size timed on the card runs
    ``paged_mla_mma_kernel`` (then the merge when the table spans more than
    one partition) and nothing else, and matches the dense plain version and,
    per element, the tiled plain version."""
    monkeypatch.setattr(paged_ops, "MLA_PARTITION", partition)
    q, kp, vp, bt, sl = _mla_inputs(cuda, torch.bfloat16, G, lens, npg, 8)

    def call():
        return paged_ops.paged_attention(q, kp, vp, bt, sl, scale=MLA_SCALE)
    before = paged_ops.KERNEL.launches
    out = call()
    assert paged_ops.KERNEL.launches == before + 1
    assert out.shape == (len(lens), G, 512) and out.dtype == torch.bfloat16
    ref = paged_ops.paged_attention(q, kp, vp, bt, sl, scale=MLA_SCALE,
                                    impl="plain")
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2,
                               rtol=3e-2)
    _assert_matches_mla_tiled(out, q, kp, vp, bt, sl)
    merged = paged_ops.mla_split_count(npg, 16) > 1
    assert _device_kernels(call) == (
        {"paged_mla_mma_kernel", "paged_merge_kernel"} if merged
        else {"paged_mla_mma_kernel"})


@pytest.mark.parametrize("partition", [64, 128])
@pytest.mark.parametrize("G,lens,npg", [
    (16, [1, 63, 64, 65, 127, 128, 129, 2000], 128),   # the serve's slots
    (16, [1, 9, 32, 31, 30, 5, 17, 2], 2),             # one partition
    (4, [1, 63, 64, 65, 127, 128, 129, 2000], 128),
])
def test_paged_mla_f32_tf32x3_kernel(cuda, monkeypatch, partition, G, lens,
                                     npg):
    """f32 MLA decode at each partition size timed on the card runs
    ``paged_mla_tf32x3_kernel`` (then the merge when the table spans more
    than one partition) and nothing else, within 1e-4 of the dense plain
    version and, per element, of the plain version that takes both
    products as three TF32 products."""
    monkeypatch.setattr(paged_ops, "MLA_PARTITION", partition)
    q, kp, vp, bt, sl = _mla_inputs(cuda, torch.float32, G, lens, npg, 9)

    def call():
        return paged_ops.paged_attention(q, kp, vp, bt, sl, scale=MLA_SCALE)
    before = paged_ops.KERNEL.launches
    out = call()
    assert paged_ops.KERNEL.launches == before + 1
    assert out.shape == (len(lens), G, 512) and out.dtype == torch.float32
    ref = paged_ops.paged_attention(q, kp, vp, bt, sl, scale=MLA_SCALE,
                                    impl="plain")
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    _assert_matches_mla_tiled(out, q, kp, vp, bt, sl)
    merged = paged_ops.mla_split_count(npg, 16) > 1
    assert _device_kernels(call) == (
        {"paged_mla_tf32x3_kernel", "paged_merge_kernel"} if merged
        else {"paged_mla_tf32x3_kernel"})


@pytest.mark.parametrize("bits", [0x7FC00000, 0x7FFFFFFF, -1])
@pytest.mark.parametrize("where", ["q", "latent", "rope"])
def test_paged_mla_f32_propagates_nan(cuda, where, bits):
    """A NaN in q (quiet, the card's canonical 0x7fffffff, and a negative
    one) reaches its head's output and no other; a NaN in a visible row,
    in its latent (value) or its rope part, reaches every head of its
    sequence and no other sequence; as in the plain version.  Every row
    past a sequence's end holds NaN and is never read."""
    lens = [1, 100, 300, 2000]
    q, kp, vp, bt, sl = _mla_inputs(cuda, torch.float32, 16, lens, 128, 10)
    page = kp.shape[1]
    tok = torch.arange(128 * page, device=cuda)
    rows = bt.long()[:, tok // page] * page + tok % page     # (B, tokens)
    past = tok[None] >= sl[:, None].long()
    flat = kp.view(-1, 576)
    flat[rows[past]] = float("nan")
    clean = flat.clone()
    clean[rows[past]] = 0.0
    b, t = {"q": (0, 0), "latent": (3, 1500), "rope": (2, 260)}[where]
    if where == "q":
        q.view(torch.int32)[b, 5, 7] = bits
    else:
        d = 100 if where == "latent" else 550
        flat.view(torch.int32)[rows[b, t], d] = bits
        clean[rows[b, t], d] = flat[rows[b, t], d]
    out = paged_ops.paged_attention(q, kp, vp, bt, sl, scale=MLA_SCALE)
    ckp = clean.view_as(kp)
    ref = paged_ops.paged_attention(q, ckp, ckp[..., :512], bt, sl,
                                    scale=MLA_SCALE, impl="plain")
    want = torch.zeros((len(lens), 16), dtype=torch.bool, device=cuda)
    if where == "q":
        want[b, 5] = True
    else:
        want[b] = True
    assert torch.equal(ref.isnan().all(-1), want)
    assert torch.equal(out.isnan().all(-1), want)
    assert not out[~want].isnan().any()
    torch.testing.assert_close(out[~want], ref[~want], atol=1e-4, rtol=1e-4)


def test_mla_wrappers_refuse_what_they_cannot_take(cuda):
    kp = torch.zeros((4, 16, 1, 576), device=cuda)
    q = torch.zeros((1, 16, 576), device=cuda)
    bt = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    sl = torch.ones((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):                     # values not a view
        paged_ops.paged_attention(q, kp, kp[..., :512].contiguous(), bt, sl)
    with pytest.raises(ValueError):                     # G = 8 at MLA dims
        paged_ops.paged_attention(q[:, :8], kp, kp[..., :512], bt, sl)
    qf = torch.zeros((1, 8, 2, 192), device=cuda)
    with pytest.raises(ValueError):                     # (192, 192)
        flash_ops.flash_attention(qf, qf, qf)


def _mla_moe_cfg():
    """deepseek-v2-lite's kernel dims at a small width: MLA with heads of
    128 + 64 rope and a 512 latent (prefill flash at (192, 128), decode
    paged at (576, 512)), 8 experts top-2 and one shared, first layer
    dense."""
    return ModelConfig(name="gpu-mla-moe", family="moe", n_layers=3,
                       d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
                       vocab_size=512, head_dim=128, use_mla=True,
                       kv_lora_rank=512, rope_head_dim=64, n_experts=8,
                       n_shared_experts=1, moe_top_k=2, moe_d_ff=128,
                       first_dense_layers=1)


def test_mla_moe_engine_kernel_path_matches_cpu_run(cuda):
    """The small MLA + MoE model served on the card in f32 (flash at
    (192, 128), paged at (576, 512) with G = 4, MoE ``dropping``) gives the
    greedy tokens of the same weights served on the CPU."""
    cfg = _mla_moe_cfg()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    pol = DtypePolicy(torch.float32, torch.float32, torch.float32)
    outs = {}
    for dev in ("cpu", cuda):
        rng = np.random.default_rng(7)
        reqs = [Request(prompt_len=int(rng.integers(5, 120)),
                        arrival_time=0.0,
                        max_new_tokens=int(rng.integers(2, 8)),
                        request_id=60_000 + i) for i in range(8)]
        eng = ServingEngine(cfg, params.to(dev), FCFSScheduler(),
                            EngineConfig(max_slots=4, s_max=256,
                                         kv_pool_tokens=2048,
                                         buckets=(32, 64, 128)),
                            policy=pol, device=dev)
        flash0, paged0 = flash_ops.KERNEL.launches, paged_ops.KERNEL.launches
        assert len(eng.run(reqs)) == len(reqs)
        if dev == cuda:
            assert flash_ops.KERNEL.launches > flash0
            assert paged_ops.KERNEL.launches > paged0
        outs[str(dev)] = eng.output_tokens
    assert outs["cpu"] == outs["cuda"]


# ---- MLA chunked prefill, and minicpm3-4b's widths --------------------------

CPM_SCALE = 96 ** -0.5         # (hd + rd)^-0.5 of minicpm3-4b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,q_offset,T", [
    (2, 200, 40, 0, 200),        # minicpm3 prefill in MHA form, ragged S
    (1, 1, 40, 0, 1),            # one token
    (1, 70, 8, 100, 256),        # a chunk at an offset into a longer cache
    (1, 512, 40, 1024, 2048),    # a suffix chunk of the prefix serve
])
def test_flash_minicpm3_dims_kernel_matches_plain(cuda, dtype, B, S, H,
                                                  q_offset, T):
    """Flash attention at (dk, dv) = (96, 64), H = K, against its plain
    version and, per element, against the tiled plain version that rounds
    as the kernel of its type does; keys past the visible ones hold NaN
    and are never read.  ``test_flash_routes_by_type`` holds which kernel
    each type runs."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn((B, S, H, 96), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, T, H, 96), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, T, H, 64), generator=g, device=cuda).to(dtype)
    kv_len = q_offset + S
    k[:, kv_len:] = float("nan")
    v[:, kv_len:] = float("nan")
    kw = dict(scale=CPM_SCALE, q_offset=q_offset, kv_len=kv_len)
    before, off0 = flash_ops.KERNEL.launches, flash_ops.KERNEL.offset_launches
    out = flash_ops.flash_attention(q, k, v, **kw)
    assert flash_ops.KERNEL.launches == before + 1
    assert flash_ops.KERNEL.offset_launches == off0 + (q_offset > 0)
    assert out.shape == (B, S, H, 64) and out.dtype == dtype
    assert torch.isfinite(out.float()).all()
    ref = flash_ops.flash_attention(q, k, v, impl="plain", **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOLS[dtype],
                               rtol=TOLS[dtype])
    if dtype == torch.bfloat16:
        tiled = flash_attention_tiled_ref(
            *(t.transpose(1, 2) for t in (q, k, v)), **kw,
            tile=flash_ops.BF16_KV_TILE[q.shape[-1]]).transpose(1, 2)
        torch.testing.assert_close(out.float(), tiled.float(),
                                   atol=TILED_ATOL, rtol=TILED_RTOL)
    else:
        _assert_matches_tf32x3(out, q, k, v, **kw)


def _cpm_inputs(cuda, dtype, lens, npg, seed):
    """minicpm3-4b's absorbed decode: q (B, 40, 288), one KV head of rows
    of 288 (latent 256 ‖ rope 32), values the view of their first 256
    columns, a shuffled table of 16-token pages."""
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=cuda).manual_seed(seed)
    B, page = len(lens), 16
    n_pool = B * npg
    q = torch.randn((B, 40, 288), generator=g, device=cuda).to(dtype)
    kp = torch.randn((n_pool, page, 1, 288), generator=g,
                     device=cuda).to(dtype)
    bt = torch.tensor(rng.permutation(n_pool).reshape(B, npg),
                      dtype=torch.int32, device=cuda)
    sl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    return q, kp, kp[..., :256], bt, sl


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lens,npg", [
    ([1, 63, 64, 65, 127, 128, 129, 2000], 128),   # the serve's slots
    ([1, 9, 32, 31, 30, 5, 17, 2], 2),             # one partition
])
def test_paged_mla_minicpm3_kernel_matches_plain(cuda, dtype, lens, npg):
    """Absorbed MLA decode at (dk, dv) = (288, 256) with G = 40 (three
    16-row head tiles of the M tile: 16, 16 and 8 live rows) runs the MLA
    kernel of its type (then the merge when the table spans more than one
    partition), and matches the dense plain version and, per element, the
    tiled plain version that rounds as the kernel does."""
    q, kp, vp, bt, sl = _cpm_inputs(cuda, dtype, lens, npg, 12)

    def call():
        return paged_ops.paged_attention(q, kp, vp, bt, sl, scale=CPM_SCALE)
    before = paged_ops.KERNEL.launches
    out = call()
    assert paged_ops.KERNEL.launches == before + 1
    assert out.shape == (len(lens), 40, 256) and out.dtype == dtype
    ref = paged_ops.paged_attention(q, kp, vp, bt, sl, scale=CPM_SCALE,
                                    impl="plain")
    torch.testing.assert_close(out.float(), ref.float(), atol=TOLS[dtype],
                               rtol=TOLS[dtype])
    bf16 = dtype == torch.bfloat16
    tiled = paged_attention_tiled_ref(q, kp, vp, bt, sl,
                                partition=paged_ops.MLA_PARTITION,
                                scale=CPM_SCALE, round_p=bf16,
                                tf32_products=0 if bf16 else 3)
    if bf16:
        torch.testing.assert_close(out.float(), tiled.float(),
                                   atol=TILED_ATOL, rtol=TILED_RTOL)
    else:
        torch.testing.assert_close(out, tiled, atol=TF32X3_ATOL,
                                   rtol=TF32X3_RTOL)
    split = "paged_mla_mma_kernel" if bf16 else "paged_mla_tf32x3_kernel"
    merged = paged_ops.mla_split_count(npg, 16) > 1
    assert _device_kernels(call) == (
        {split, "paged_merge_kernel"} if merged else {split})


@pytest.mark.parametrize("head", [3, 20, 37])
def test_paged_mla_f32_minicpm3_nan_stays_in_its_head(cuda, head):
    """f32: a NaN in one query head, in the first, second or third head
    tile, reaches that head's output and no other."""
    lens = [5, 300, 2000]
    q, kp, vp, bt, sl = _cpm_inputs(cuda, torch.float32, lens, 128, 13)
    q[1, head, 40] = float("nan")
    out = paged_ops.paged_attention(q, kp, vp, bt, sl, scale=CPM_SCALE)
    want = torch.zeros((len(lens), 40), dtype=torch.bool, device=cuda)
    want[1, head] = True
    assert torch.equal(out.isnan().all(-1), want)
    assert not out[~want].isnan().any()


def _mla_cfg(dims: str):
    """A small MLA model at one family's kernel widths: deepseek-v2-lite's
    (heads of 128 + 64 rope, latent 512; 8 experts top-2 with one shared,
    first layer dense) or minicpm3-4b's (40 heads of 64 + 32 rope, latent
    256, dense MLPs)."""
    if dims == "deepseek":
        return _mla_moe_cfg()
    return ModelConfig(name="gpu-minicpm3", family="dense", n_layers=2,
                       d_model=256, n_heads=40, n_kv_heads=40, d_ff=512,
                       vocab_size=512, head_dim=64, use_mla=True,
                       kv_lora_rank=256, rope_head_dim=32)


@pytest.mark.parametrize("dims", ["deepseek", "minicpm3"])
def test_mla_chunk_step_in_pieces_matches_prefill_on_card(cuda, dims):
    """A small MLA model's prompt through chunk_step in chunks of 64, 64
    and 29 on the card (keys and values decompressed from the latent rows,
    flash at a query offset) gives the logits and latent rows of one
    prefill on the card, and of the CPU run (MoE ``dense``, so chunks and
    one prefill route alike)."""
    from repro_torch.models import chunk_step, init_decode_caches, prefill
    cfg = _mla_cfg(dims)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    pol = DtypePolicy(torch.float32, torch.float32, torch.float32)
    toks = torch.tensor(np.random.default_rng(3).integers(0, 512, (1, 157)))
    got = {}
    for dev in ("cpu", cuda):
        p = params.to(dev)
        ref, ref_c = prefill(p, {"tokens": toks.to(dev)}, cfg, policy=pol,
                             moe_impl="dense")
        caches = init_decode_caches(cfg, 1, 256, dtype=torch.float32,
                                    device=dev)
        pos, off0 = 0, flash_ops.KERNEL.offset_launches
        for w in (64, 64, 29):
            logits, caches = chunk_step(p, toks[:, pos:pos + w].to(dev),
                                        caches, pos, cfg, policy=pol,
                                        moe_impl="dense")
            pos += w
        if dev == cuda:
            assert flash_ops.KERNEL.offset_launches == \
                off0 + 2 * cfg.n_layers
        torch.testing.assert_close(logits, ref, atol=1e-4, rtol=1e-4)
        for layer, r in zip(caches, ref_c):
            torch.testing.assert_close(layer["ckv"][:, :157], r["ckv"],
                                       atol=1e-4, rtol=1e-4)
        got[str(dev)] = logits.cpu()
    torch.testing.assert_close(got["cuda"], got["cpu"], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dims", ["deepseek", "minicpm3"])
def test_mla_chunked_radix_engine_kernel_path_matches_cpu_run(cuda, dims):
    """A small MLA model served on the card in chunked + radix mode over
    shared-prefix requests (f32; deepseek's widths with MoE ``dropping``)
    gives the CPU run's greedy tokens and attached prefixes, with flash
    launched at a query offset and paged MLA decode."""
    cfg = _mla_cfg(dims)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    pol = DtypePolicy(torch.float32, torch.float32, torch.float32)
    rng = np.random.default_rng(4)
    prefix = rng.integers(0, 512, size=(64,)).astype(np.int32)
    specs = [(np.concatenate([prefix, rng.integers(0, 512, size=(int(n),))
                              .astype(np.int32)]), int(m))
             for n, m in zip(rng.integers(5, 60, 10), rng.integers(2, 8, 10))]
    outs, cached = {}, {}
    for dev in ("cpu", cuda):
        reqs = [Request(prompt_len=len(t), arrival_time=0.0,
                        max_new_tokens=m, prompt_tokens=t.copy(),
                        request_id=95_000 + i) for i, (t, m) in enumerate(specs)]
        eng = ServingEngine(cfg, params.to(dev), FCFSScheduler(),
                            EngineConfig(max_slots=4, s_max=256,
                                         kv_pool_tokens=4096,
                                         chunk_prefill_tokens=48,
                                         enable_prefix_cache=True),
                            policy=pol, device=dev)
        off0, paged0 = (flash_ops.KERNEL.offset_launches,
                        paged_ops.KERNEL.launches)
        assert len(eng.run(reqs)) == len(reqs)
        if dev == cuda:
            assert flash_ops.KERNEL.offset_launches > off0
            assert paged_ops.KERNEL.launches > paged0
        eng.radix.check_invariants()
        outs[str(dev)] = eng.output_tokens
        cached[str(dev)] = {r.request_id: r.cached_len for r in eng.finished}
    assert outs["cpu"] == outs["cuda"]
    assert cached["cpu"] == cached["cuda"]
    assert sum(c > 0 for c in cached["cuda"].values()) >= 4


def test_minicpm3_dims_engine_kernel_path_matches_cpu_run(cuda):
    """The small model at minicpm3-4b's widths served bucketed on the card
    in f32 (flash at (96, 64), paged at (288, 256) with G = 40) gives the
    greedy tokens of the same weights served on the CPU."""
    cfg = _mla_cfg("minicpm3")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    pol = DtypePolicy(torch.float32, torch.float32, torch.float32)
    outs = {}
    for dev in ("cpu", cuda):
        rng = np.random.default_rng(7)
        reqs = [Request(prompt_len=int(rng.integers(5, 120)),
                        arrival_time=0.0,
                        max_new_tokens=int(rng.integers(2, 8)),
                        request_id=61_000 + i) for i in range(8)]
        eng = ServingEngine(cfg, params.to(dev), FCFSScheduler(),
                            EngineConfig(max_slots=4, s_max=256,
                                         kv_pool_tokens=2048,
                                         buckets=(32, 64, 128)),
                            policy=pol, device=dev)
        flash0, paged0 = flash_ops.KERNEL.launches, paged_ops.KERNEL.launches
        assert len(eng.run(reqs)) == len(reqs)
        if dev == cuda:
            assert flash_ops.KERNEL.launches > flash0
            assert paged_ops.KERNEL.launches > paged0
        outs[str(dev)] = eng.output_tokens
    assert outs["cpu"] == outs["cuda"]


# ---- the sliding-window families: flash at (80, 80) and (256, 256), paged
# at hd 80 (G = 4) and 256 (G = 2), over slot caches and wrapped rings ------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,G,W", [(80, 4, 256), (256, 2, 1024)])
def test_gqa_decode_ring_kernel_matches_plain(cuda, dtype, hd, G, W):
    """One decode step over ring caches of W slots (random contents), rows
    before the ring is full, at its last slot and wrapped more than once:
    the kernel path (the ring as pages, ``seq_lens = min(pos + 1, W)``)
    against the plain path, and the same ring writes."""
    from repro_torch.models.attention import gqa_decode_ring, init_attention
    cfg = ModelConfig(name="gpu-ring", family="dense", n_layers=1,
                      d_model=256, n_heads=2 * G, n_kv_heads=2, d_ff=512,
                      vocab_size=64, head_dim=hd, attn_kind="swa", window=W)
    g = torch.Generator(device=cuda).manual_seed(W)
    params = init_attention(g, cfg, dtype, cuda)
    pos = torch.tensor([5, W - 1, 3 * W + 17], device=cuda)
    x = torch.randn((3, 1, 256), generator=g, device=cuda).to(dtype)
    ring = {n: torch.randn((3, W, 2, hd), generator=g, device=cuda).to(dtype)
            for n in ("k", "v")}
    plain = {n: t.clone() for n, t in ring.items()}
    before = paged_ops.KERNEL.launches
    y, ring = gqa_decode_ring(params, x, ring, pos, cfg, window=W)
    assert paged_ops.KERNEL.launches == before + 1
    y_ref, plain = gqa_decode_ring(params, x, plain, pos, cfg, window=W,
                                   impl="plain")
    torch.testing.assert_close(y.float(), y_ref.float(), atol=TOLS[dtype],
                               rtol=TOLS[dtype])
    for n in ("k", "v"):
        assert torch.equal(ring[n], plain[n])


@pytest.mark.parametrize("many", [False, True])
@pytest.mark.parametrize("hd", [64, 128, 80, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_nan_stays_in_its_head(cuda, dtype, hd, many):
    """A NaN in one element of one query head gives that head NaN and no
    other, with one partition (the split kernel writes the output) and
    with several (the merge writes it): the tile max takes NaN (max.NaN),
    so neither the split nor the merge reads the head as empty."""
    G = {80: 4, 256: 2}.get(hd, 4)
    lens, npg = ([5, 300, 2000], 128) if many else ([5, 100, 128], 8)
    q, kp, vp, bt, sl = _paged_inputs(
        np.random.default_rng(hd), torch.Generator(device=cuda).manual_seed(hd),
        cuda, dtype, lens, 2 * G, 2, hd, 16, npg, shuffle=True)
    assert (npg * 16 > paged_ops.partition_for(hd, hd, G, dtype)) == many
    head = G + 1                      # a head of the second KV head's group
    q[1, head, 7] = float("nan")
    out = paged_ops.paged_attention(q, kp, vp, bt, sl)
    want = torch.zeros((len(lens), 2 * G), dtype=torch.bool, device=cuda)
    want[1, head] = True
    assert torch.equal(out.isnan().all(-1), want)
    assert not out[~want].isnan().any()


@pytest.mark.parametrize("head", [3, 20, 37])
def test_paged_mla_bf16_minicpm3_nan_stays_in_its_head(cuda, head):
    """bf16 (``paged_mla_mma_kernel``, 16 partitions and the merge): a NaN
    in one query head, in the first, second or third head tile, reaches
    that head's output and no other."""
    lens = [5, 300, 2000]
    q, kp, vp, bt, sl = _cpm_inputs(cuda, torch.bfloat16, lens, 128, 13)
    q[1, head, 40] = float("nan")
    out = paged_ops.paged_attention(q, kp, vp, bt, sl, scale=CPM_SCALE)
    want = torch.zeros((len(lens), 40), dtype=torch.bool, device=cuda)
    want[1, head] = True
    assert torch.equal(out.isnan().all(-1), want)
    assert not out[~want].isnan().any()


def _spill_bytes(lib: str, kernel: str, type_tag: str, ints: tuple) -> int:
    """Spill-store bytes ``nvcc -Xptxas -v`` reported for one instance of
    ``kernel`` in the library built from ``csrc/<lib>.cu``: the entry whose
    mangled name carries ``type_tag`` (``f`` for float, ``13__nv_bfloat16``;
    empty for a kernel templated on ints alone) and the template ints."""
    import re
    from repro_torch.kernels import _build
    _build.build((lib,))
    log = (_build.library_path(lib).parent / "build.log").read_text()
    want = (kernel + "I" + type_tag
            + "".join(f"Li{n}E" for n in ints) + "E")
    entry, found = None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and entry and want in entry:
            found[entry] = int(m.group(1))
    assert len(found) == 1, (want, sorted(found))
    return next(iter(found.values()))


@pytest.mark.parametrize("lib,kernel,type_tag,ints", [
    ("flash_attention", "flash_fwd_wgmma_kernel", "", (80, 80)),
    ("flash_attention", "flash_fwd_wgmma_kernel", "", (256, 256)),
    ("flash_attention", "flash_fwd_tf32x3_kernel", "", (80, 80)),
    ("flash_attention", "flash_fwd_tf32x3_kernel", "", (256, 256)),
    ("paged_attention", "paged_gqa_tf32x3_kernel", "", (80, 4)),
    ("paged_attention", "paged_gqa_tf32x3_kernel", "", (256, 2)),
    ("paged_attention", "paged_gqa_tf32x3_kernel", "", (256, 16)),
    ("paged_attention", "paged_gqa_mma_kernel", "", (80, 4)),
    ("paged_attention", "paged_gqa_mma_kernel", "", (256, 2)),
    ("paged_attention", "paged_gqa_mma_kernel", "", (256, 16)),
])
def test_ring_dims_instances_do_not_spill(cuda, lib, kernel, type_tag, ints):
    """The sliding-window families' kernel instances keep every register
    (ptxas reports no spill store): bf16 flash at (256, 256) beside its
    128-register output accumulator; grouped paged decode runs the
    tensor-core kernels in both types, recurrentgemma's G = 16 at hd 256
    too."""
    assert _spill_bytes(lib, kernel, type_tag, ints) == 0


# ---- recurrentgemma-9b: paged hd 256 at G = 16 (one M tile),
# flash (256, 256) at H 16 / K 1 with window 2048, the RG-LRU engine -------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,hd,lens,npg", [
    (1, 256, [1, 255, 256, 257, 511, 512, 513, 2000], 128),  # partition edges
    (1, 256, [2048] * 8, 128),                               # 8 full rings
    (2, 256, [5, 300, 1024], 64),                            # two KV heads
    (2, 64, [5, 257, 700], 64),                              # other widths
    (2, 80, [5, 257, 700], 64),
    (2, 128, [5, 257, 700], 64),
])
def test_paged_g16_kernel_matches_plain(cuda, dtype, K, hd, lens, npg):
    """recurrentgemma's decode instance: 16 query heads a KV head at hd
    256, shuffled table, against the plain version and, per element, the
    tiled one; one counted launch.  Both types run a grouped tensor-core
    kernel (one M tile of 16 rows) at every width, so hd 64, 80 and 128 are
    held too."""
    q, kp, vp, bt, sl = _paged_inputs(
        np.random.default_rng(16), torch.Generator(device=cuda).manual_seed(16),
        cuda, dtype, lens, 16 * K, K, hd, 16, npg, shuffle=True)
    before = paged_ops.KERNEL.launches
    out = paged_ops.paged_attention(q, kp, vp, bt, sl)
    assert paged_ops.KERNEL.launches == before + 1
    ref = paged_ops.paged_attention(q, kp, vp, bt, sl, impl="plain")
    torch.testing.assert_close(out.float(), ref.float(), atol=TOLS[dtype],
                               rtol=TOLS[dtype])
    _assert_matches_gqa_tiled(out, q, kp, vp, bt, sl)


@pytest.mark.parametrize("many", [False, True])
@pytest.mark.parametrize("head", [3, 8, 15])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_g16_nan_stays_in_its_head(cuda, dtype, head, many):
    """A NaN in one query head of G = 16 (hd 256; one M tile in either
    type) gives that head NaN and no other, with one partition and with
    several."""
    lens, npg = ([5, 300, 2000], 128) if many else ([5, 100, 128], 8)
    q, kp, vp, bt, sl = _paged_inputs(
        np.random.default_rng(head), torch.Generator(device=cuda).manual_seed(
            head), cuda, dtype, lens, 16, 1, 256, 16, npg, shuffle=True)
    q[1, head, 7] = float("nan")
    out = paged_ops.paged_attention(q, kp, vp, bt, sl)
    want = torch.zeros((len(lens), 16), dtype=torch.bool, device=cuda)
    want[1, head] = True
    assert torch.equal(out.isnan().all(-1), want)
    assert not out[~want].isnan().any()


@pytest.mark.parametrize("many", [False, True])
@pytest.mark.parametrize("G,K,head", [
    (16, 1, 0), (16, 1, 15),            # the M tile's first and last row
    (16, 2, 16 + 9),                    # a head of the second KV head
    (4, 2, 4 + 3),                      # rows 4..15 of the M tile are zero
    (4, 1, 0),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_gqa_nan_stays_in_its_head(cuda, dtype, G, K, head, many):
    """Grouped decode at hd 256 (``paged_gqa_mma_kernel`` in bf16,
    ``paged_gqa_tf32x3_kernel`` in f32): a NaN in one query head reaches
    that head's output and no other, with one partition and with several
    (the merge); at G = 4 the zero rows of the M tile leak nothing."""
    P = paged_ops.partition_for(256, 256, G, dtype)
    lens, npg = ([5, P - 3, P], P // 16) if not many else ([5, 300, 2000],
                                                            128)
    q, kp, vp, bt, sl = _paged_inputs(
        np.random.default_rng(head), torch.Generator(device=cuda).manual_seed(
            head), cuda, dtype, lens, G * K, K, 256, 16, npg,
        shuffle=True)
    assert (npg * 16 > P) == many
    q[1, head, 11] = float("nan")
    out = paged_ops.paged_attention(q, kp, vp, bt, sl)
    want = torch.zeros((len(lens), G * K), dtype=torch.bool, device=cuda)
    want[1, head] = True
    assert torch.equal(out.isnan().all(-1), want)
    assert not out[~want].isnan().any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,window", [(2048, 2048), (700, 2048), (700, 256)])
def test_flash_mqa_hd256_window_matches_plain(cuda, dtype, S, window):
    """recurrentgemma's prefill shape: 16 query heads on 1 KV head at (256,
    256), local window 2048 (and 256, so that the window cuts)."""
    g = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn((1, S, 16, 256), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((1, S, 1, 256), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    before = flash_ops.KERNEL.window_launches
    out = flash_ops.flash_attention(q, k, v, window=window)
    assert flash_ops.KERNEL.window_launches == before + 1
    ref = flash_ops.flash_attention(q, k, v, window=window, impl="plain")
    torch.testing.assert_close(out.float(), ref.float(), atol=TOLS[dtype],
                               rtol=TOLS[dtype])
    if dtype == torch.bfloat16:
        _assert_matches_tiled(out, q, k, v, True, window)
    else:
        _assert_matches_tf32x3(out, q, k, v, causal=True, window=window)


def test_rglru_engine_kernel_path_matches_cpu_run(cuda):
    """A small hybrid model at recurrentgemma's attention widths (MQA, hd
    256, G = 16, window 64) served on the card through flash and paged
    (mixed prompt lengths, unpadded; some prompts and decodes past the
    window) gives the greedy tokens of the same weights served on the
    CPU."""
    cfg = ModelConfig(name="gpu-rglru", family="hybrid", n_layers=5,
                      d_model=256, n_heads=16, n_kv_heads=1, d_ff=512,
                      vocab_size=256, head_dim=256, rnn_width=256,
                      pattern=("rglru", "rglru", "local"), window=64,
                      tie_embeddings=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    pol = DtypePolicy(torch.float32, torch.float32, torch.float32)
    outs = {}
    for dev in ("cpu", cuda):
        rng = np.random.default_rng(5)
        reqs = [Request(prompt_len=int(rng.integers(5, 90)), arrival_time=0.0,
                        max_new_tokens=int(rng.integers(2, 40)),
                        request_id=90_000 + i) for i in range(8)]
        eng = ServingEngine(cfg, params.to(dev), FCFSScheduler(),
                            EngineConfig(max_slots=4, s_max=160,
                                         kv_pool_tokens=2048),
                            policy=pol, device=dev)
        flash0, paged0 = flash_ops.KERNEL.launches, paged_ops.KERNEL.launches
        assert len(eng.run(reqs)) == len(reqs)
        if dev == cuda:
            assert flash_ops.KERNEL.launches > flash0
            assert paged_ops.KERNEL.launches > paged0
        outs[str(dev)] = eng.output_tokens
    assert outs["cpu"] == outs["cuda"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1024, 1000, 1])
def test_flash_bidirectional_hd80_matches_plain(cuda, dtype, S):
    """hubert-xlarge's attention: bidirectional flash at (80, 80), H = K =
    16, B = 2.  Every query tile walks every key tile, and only the
    visible-key test masks the keys past S in the last tile (S = 1000) or
    all but one (S = 1).  Against the dense plain version and, per element,
    the tiled one that rounds as the kernel does; one counted launch."""
    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn((2, S, 16, 80), generator=g, device=cuda)
               .to(dtype) for _ in range(3))
    before = flash_ops.KERNEL.launches
    out = flash_ops.flash_attention(q, k, v, causal=False)
    assert flash_ops.KERNEL.launches == before + 1
    ref = flash_ops.flash_attention(q, k, v, causal=False, impl="plain")
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=TOLS[dtype],
                               rtol=TOLS[dtype])
    if dtype == torch.bfloat16:
        _assert_matches_tiled(out, q, k, v, False, 0)
    else:
        _assert_matches_tf32x3(out, q, k, v, causal=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_internvl2_heads_match_plain(cuda, dtype):
    """Causal flash and paged decode at internvl2-76b's heads against their
    plain versions (bf16 paged also per element against the tiled one),
    one counted launch each."""
    (q, k, v), (pq, kp, vp, bt, sl) = _internvl2_inputs(cuda, dtype)
    before = flash_ops.KERNEL.launches
    out = flash_ops.flash_attention(q, k, v)
    assert flash_ops.KERNEL.launches == before + 1
    ref = flash_ops.flash_attention(q, k, v, impl="plain")
    torch.testing.assert_close(out.float(), ref.float(), atol=TOLS[dtype],
                               rtol=TOLS[dtype])
    before = paged_ops.KERNEL.launches
    out = paged_ops.paged_attention(pq, kp, vp, bt, sl)
    assert paged_ops.KERNEL.launches == before + 1
    ref = paged_ops.paged_attention(pq, kp, vp, bt, sl, impl="plain")
    torch.testing.assert_close(out.float(), ref.float(), atol=TOLS[dtype],
                               rtol=TOLS[dtype])
    if dtype == torch.bfloat16:
        _assert_matches_gqa_tiled(out, pq, kp, vp, bt, sl)


def test_hubert_smoke_encoder_on_card_matches_cpu(cuda):
    """hubert-xlarge's smoke config at its head width of 80 (bidirectional,
    GeLU MLPs, no embedding table) run on the card through flash gives the
    per-position logits of the same weights and frames on the CPU, in
    f32."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import prefill
    cfg = get_smoke_config("hubert-xlarge").scaled(head_dim=80)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    pol = DtypePolicy(torch.float32, torch.float32, torch.float32)
    frames = torch.tensor(np.random.default_rng(8).standard_normal(
        (3, 77, cfg.d_model)).astype(np.float32))
    want, _ = prefill(params, {"embeddings": frames}, cfg, policy=pol)
    before = flash_ops.KERNEL.launches
    got, cache = prefill(params.to(cuda), {"embeddings": frames.to(cuda)},
                         cfg, policy=pol)
    assert cache is None
    assert flash_ops.KERNEL.launches == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def test_internvl2_smoke_engine_on_card_matches_cpu_run(cuda):
    """internvl2-76b's smoke config at its head width and group (hd 128, 8
    query heads on 1 KV head; prompts embedded through the table and
    prefilled as embeddings, decode on tokens) served on the card through
    flash and paged gives the f32 greedy tokens of the same weights served
    on the CPU."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("internvl2-76b").scaled(n_heads=8, n_kv_heads=1,
                                                   head_dim=128)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    pol = DtypePolicy(torch.float32, torch.float32, torch.float32)
    outs = {}
    for dev in ("cpu", cuda):
        rng = np.random.default_rng(9)
        reqs = [Request(prompt_len=int(rng.integers(5, 90)), arrival_time=0.0,
                        max_new_tokens=int(rng.integers(2, 12)),
                        request_id=95_000 + i) for i in range(8)]
        eng = ServingEngine(cfg, params.to(dev), FCFSScheduler(),
                            EngineConfig(max_slots=4, s_max=128,
                                         kv_pool_tokens=2048,
                                         buckets=(32, 64, 128)),
                            policy=pol, device=dev)
        flash0, paged0 = flash_ops.KERNEL.launches, paged_ops.KERNEL.launches
        assert len(eng.run(reqs)) == len(reqs)
        if dev == cuda:
            assert flash_ops.KERNEL.launches > flash0
            assert paged_ops.KERNEL.launches > paged0
        outs[str(dev)] = eng.output_tokens
    assert outs["cpu"] == outs["cuda"]


@pytest.mark.parametrize("name", ["flash_attention", "paged_attention",
                                  "ssd_chunk"])
def test_wrappers_refuse_autograd_on_card(cuda, name):
    """A kernel's output has no grad_fn: each wrapper refuses an input that
    requires grad under grad mode instead of losing its gradient."""
    g = torch.Generator(device=cuda).manual_seed(0)

    def r(*shape, grad=False):
        return torch.randn(shape, generator=g, device=cuda,
                           requires_grad=grad)

    table = torch.arange(2, dtype=torch.int32, device=cuda)[None]
    lens = torch.tensor([20], dtype=torch.int32, device=cuda)
    call = {"flash_attention": lambda: flash_ops.flash_attention(
                r(1, 64, 2, 64, grad=True), r(1, 64, 2, 64), r(1, 64, 2, 64)),
            "paged_attention": lambda: paged_ops.paged_attention(
                r(1, 2, 64, grad=True), r(2, 16, 2, 64), r(2, 16, 2, 64),
                table, lens),
            "ssd_chunk": lambda: ssd_ops.ssd_chunk(
                r(1, 1, 64, 2, 64, grad=True), r(1, 1, 64, 2).abs(), r(2),
                r(1, 1, 64, 1, 64), r(1, 1, 64, 1, 64))}[name]
    with pytest.raises(RuntimeError, match="training attention"):
        call()


def test_train_steps_on_card_match_cpu(cuda):
    """Two AdamW steps of llama2-13b's smoke config in f32 on the card
    (cuBLAS and CUDA autograd; no kernel of the repository) give the CPU's
    losses and gradient norms from the same weights and batches."""
    import copy

    from repro_torch.configs import get_smoke_config
    from repro_torch.training import (AdamWConfig, DataConfig, TokenDataset,
                                      adamw_init, batch_to, init_train_state,
                                      make_train_step)
    cfg = get_smoke_config("llama2-13b")
    pol = DtypePolicy(torch.float32, torch.float32, torch.float32)
    cpu_p, cpu_st = init_train_state(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    card_p = copy.deepcopy(cpu_p).to(cuda)
    card_st = adamw_init(card_p)
    it = TokenDataset(cfg, DataConfig(global_batch=2, seq_len=64)).batches()
    batches = [next(it) for _ in range(2)]
    launches = (flash_ops.KERNEL.launches, paged_ops.KERNEL.launches)
    metrics = {}
    for dev, p, st in (("cpu", cpu_p, cpu_st), ("cuda", card_p, card_st)):
        step = make_train_step(cfg, AdamWConfig(lr_peak=1e-3, warmup_steps=1,
                                                total_steps=2), policy=pol)
        metrics[dev] = []
        for b in batches:
            p, st, m = step(p, st, batch_to(b, dev))
            metrics[dev].append((float(m["loss"]), float(m["grad_norm"])))
    assert (flash_ops.KERNEL.launches, paged_ops.KERNEL.launches) == launches
    for (lc, nc), (lg, ng) in zip(metrics["cpu"], metrics["cuda"]):
        assert abs(lg - lc) <= 1e-5 * abs(lc)
        assert abs(ng - nc) <= 1e-5 * nc


@pytest.mark.parametrize("eps", [1e-8, 1.0])
@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b",
                                  "deepseek-v2-lite-16b", "minicpm3-4b"])
def test_family_train_step_on_card_matches_cpu(cuda, arch, eps):
    """Three AdamW steps of each SSM, RG-LRU and MLA family's smoke config
    in f32 on the card give the CPU's losses and gradient norms from the
    same weights and batches (S 48: mamba2's chunks of 32 padded); no
    kernel of the repository launches.  Each case prints its relative
    differences as one JSON line (``pytest -s``).

    At Adam's default eps (1e-8) a step moves each weight by about ±lr
    whatever its gradient's size, so an entry near zero whose sign the
    rounding decides moves by 2·lr more on one side, and the next
    gradients follow: on the H100 mamba2's second and third gradient norms
    were 2.5e-4 and 5.4e-4 apart, with every loss within 1e-5.  With eps
    1.0 a step is lr times the gradient's moment, which rounding moves by
    no more than its own size; there every norm and every weight, within
    1e-5 of its leaf's scale, agree.  So the weights are compared at eps
    1.0, and at 1e-8 mamba2 alone has only its first norm held."""
    import copy
    import json

    from repro_torch.configs import get_smoke_config
    from repro_torch.training import (AdamWConfig, DataConfig, TokenDataset,
                                      adamw_init, batch_to, init_train_state,
                                      make_train_step)
    cfg = get_smoke_config(arch)
    pol = DtypePolicy(torch.float32, torch.float32, torch.float32)
    cpu_p, cpu_st = init_train_state(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    card_p = copy.deepcopy(cpu_p).to(cuda)
    card_st = adamw_init(card_p)
    it = TokenDataset(cfg, DataConfig(global_batch=2, seq_len=48)).batches()
    batches = [next(it) for _ in range(3)]
    kernels = (flash_ops.KERNEL, paged_ops.KERNEL, ssd_ops.KERNEL)
    launches = [k.launches for k in kernels]
    metrics, weights = {}, {}
    for dev, p, st in (("cpu", cpu_p, cpu_st), ("cuda", card_p, card_st)):
        step = make_train_step(cfg, AdamWConfig(lr_peak=1e-3, warmup_steps=1,
                                                total_steps=2, eps=eps),
                               policy=pol)
        metrics[dev] = []
        for b in batches:
            p, st, m = step(p, st, batch_to(b, dev))
            metrics[dev].append((float(m["loss"]), float(m["grad_norm"])))
        weights[dev] = {k: v.detach().cpu() for k, v in p.named_parameters()}
    assert [k.launches for k in kernels] == launches
    loss_rel = [abs(g[0] - c[0]) / abs(c[0])
                for c, g in zip(metrics["cpu"], metrics["cuda"])]
    norm_rel = [abs(g[1] - c[1]) / c[1]
                for c, g in zip(metrics["cpu"], metrics["cuda"])]
    weight_rel = {k: float((weights["cuda"][k] - w).abs().max()
                           / w.abs().max().clamp_min(1e-30))
                  for k, w in weights["cpu"].items()}
    worst = max(weight_rel, key=weight_rel.get)
    print(json.dumps({"arch": arch, "eps": eps, "loss_rel": loss_rel,
                      "norm_rel": norm_rel, "weights_worst": worst,
                      "weights_rel": weight_rel[worst]}))
    held = 1 if eps < 1.0 and arch == "mamba2-370m" else len(batches)
    assert max(loss_rel) <= 1e-5, loss_rel
    assert max(norm_rel[:held]) <= 1e-5, norm_rel
    if eps == 1.0:
        assert weight_rel[worst] <= 1e-5, (worst, weight_rel[worst])


@pytest.mark.parametrize("mixer", ["ssm", "mla"])
def test_prefill_mixers_refuse_autograd_on_card(cuda, mixer):
    """``ssm_forward`` and ``mla_forward`` in prefill mode reach the SSD
    and flash wrappers, which raise for weights that require grad; with
    ``train=True`` the same call runs and carries a gradient."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.attention import mla_forward
    from repro_torch.models.ssm import ssm_forward
    arch = "mamba2-370m" if mixer == "ssm" else "deepseek-v2-lite-16b"
    cfg = get_smoke_config(arch)
    g = torch.Generator(device=cuda).manual_seed(0)
    params = init_params(cfg, g, device=cuda).requires_grad_(True)
    weights = dict(params.blocks[0].mixer)
    x = torch.randn((1, 64, cfg.d_model), generator=g, device=cuda)
    pos = torch.arange(64, device=cuda)[None]

    def run(train):
        if mixer == "ssm":
            return ssm_forward(weights, x, cfg, train=train)
        return mla_forward(weights, x, cfg, positions=pos, train=train)

    with pytest.raises(RuntimeError, match="training attention"):
        run(False)
    y = run(True)
    (gw,) = torch.autograd.grad(y.sum(), [next(iter(weights.values()))])
    assert torch.isfinite(gw).all()




# ---- paged partials and the sharded decode on a one-rank NCCL mesh --------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,K,hd,hd_v", [(8, 8, 128, 128), (8, 4, 64, 64),
                                         (16, 1, 256, 256),
                                         (16, 1, 576, 512)])
def test_paged_partials_merge_to_the_kernel_output(cuda, dtype, H, K, hd,
                                                   hd_v):
    """``paged_attention_partials`` on the card (one launch, at least two
    partitions' states) merged by ``merge_partials_ref`` against the plain
    split version over the whole table merged alike, and against
    ``paged_attention``: G = 1, 2 and 16, MLA's (576, 512), lens of 0 (an
    empty shard), 1 and across partitions."""
    from repro_torch.kernels.paged_attention.ref import merge_partials_ref
    g = torch.Generator(device=cuda).manual_seed(5)
    B, page, npg = 4, 16, 24
    q = torch.randn((B, H, hd), generator=g, device=cuda).to(dtype)
    kp = torch.randn((B * npg, page, K, hd), generator=g,
                     device=cuda).to(dtype)
    vp = (kp[..., :hd_v] if hd_v != hd else
          torch.randn((B * npg, page, K, hd), generator=g,
                      device=cuda).to(dtype))
    table = torch.arange(B * npg, dtype=torch.int32,
                         device=cuda).view(B, npg)
    lens = torch.tensor([0, 1, 200, 384], dtype=torch.int32, device=cuda)
    # a freed block of NaN, which the caching allocator hands back to the
    # partials buffer: an empty partition's unwritten output must not leak
    poison = torch.full((1 << 22,), float("nan"), device=cuda)
    del poison
    before = paged_ops.KERNEL.launches
    m, l, o = paged_ops.paged_attention_partials(q, kp, vp, table, lens)
    assert paged_ops.KERNEL.launches == before + 1
    pm, pl, po = paged_ops.paged_attention_partials(q, kp, vp, table, lens,
                                                    impl="plain")
    tol = TOLS[dtype]
    assert m.shape[2] >= 2 and pm.shape[2] == 1
    assert bool((m[0] == -np.inf).all()) and bool((pm[0] == -np.inf).all())
    assert float((l[0]).abs().max()) == 0.0 and bool(torch.isfinite(o).all())
    got = merge_partials_ref(m, l, o)
    want = merge_partials_ref(pm, pl, po)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= tol * scale
    ref = paged_ops.paged_attention(q, kp, vp, table, lens).float()
    assert float((got[1:] - ref[1:]).abs().max()) <= tol * scale


def test_sharded_decode_on_one_rank_nccl_mesh_matches_plain(cuda):
    """qwen3-4b's smoke config at hd 64 (4 query heads, 2 KV heads) in f32:
    a prefill and 8 greedy decode steps on weights distributed under the
    serve policy on a one-rank NCCL (1, 1) mesh, decode over caches whose
    sequence is placed over "model" (the sharded decode: paged partials,
    then their merge), against the same calls on the plain weights."""
    from repro_torch.configs import get_smoke_config
    _one_rank_sharded_decode(cuda,
                             get_smoke_config("qwen3-4b").scaled(head_dim=64))


def test_sharded_mla_decode_on_one_rank_nccl_mesh_matches_plain(cuda):
    """The small MLA + MoE model at deepseek-v2-lite's kernel dims (paged
    at (576, 512), G = 4) in f32, as the test above: the sharded decode
    over its one latent cache ("ckv", values its first 512 columns) and
    the sharded ``dropping`` against the plain calls, step by step."""
    _one_rank_sharded_decode(cuda, _mla_moe_cfg())


def _one_rank_sharded_decode(cuda, cfg):
    """``cfg``'s prefill and 8 greedy decode steps, plain and sharded on a
    one-rank NCCL (1, 1) mesh: one paged launch a layer a step, equal
    greedy tokens and logits within 1e-4 of scale."""
    import socket

    import torch.distributed as dist
    from repro_torch.distributed.sharding import (
        ShardingPolicy, batch_axes_for, distribute_batch, distribute_caches,
        distribute_params)
    from repro_torch.distributed.spmd import spmd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import (decode_step, init_decode_caches,
                                          prefill)
    f32 = DtypePolicy(torch.float32, torch.float32, torch.float32)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 40))).int().to(cuda)

    def greedy(p, pol=None):
        place = ((lambda t: distribute_batch({"t": t}, pol)["t"]) if pol
                 else (lambda t: t))
        whole = (lambda t: t.full_tensor()) if pol else (lambda t: t)
        logits, caches = prefill(p, {"tokens": place(tokens)}, cfg,
                                 policy=f32)
        slot = init_decode_caches(cfg, 4, 64, dtype=torch.float32,
                                  device=cuda)
        for c, pc in zip(slot, caches):
            for k in c:
                c[k][:, :40] = whole(pc[k])
        if pol:
            slot = distribute_caches(slot, pol)
        out = [whole(logits)[:, 0]]
        for i in range(8):
            tok = out[-1].argmax(-1, keepdim=True).int()
            logits, slot = decode_step(p, place(tok), slot, 40 + i, cfg,
                                       policy=f32)
            out.append(whole(logits)[:, 0])
        return torch.stack(out)

    want = greedy(params)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_host_mesh(1, device_type="cuda")
        pol = ShardingPolicy(mesh, "serve", cfg,
                             batch_axes=batch_axes_for(mesh))
        before = paged_ops.KERNEL.launches
        with spmd():
            got = greedy(distribute_params(params, pol), pol)
        launches = paged_ops.KERNEL.launches - before
    finally:
        dist.destroy_process_group()
    assert launches == 8 * cfg.n_layers
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
