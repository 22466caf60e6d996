"""The PyTorch port's CUDA kernels on a GPU: each against its plain version,
and the engine's kernel path against its CPU run.  Marked ``gpu``; every test
skips where no CUDA device is visible.  On the card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import FCFSScheduler, Request
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_tiled_ref
from repro_torch.kernels.paged_attention import ops as paged_ops
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


def _assert_matches_tiled(out, q, k, v, causal, window):
    ref = flash_attention_tiled_ref(*(t.transpose(1, 2) for t in (q, k, v)),
                                    causal=causal, window=window)
    torch.testing.assert_close(out.float(), ref.transpose(1, 2).float(),
                               atol=TILED_ATOL, rtol=TILED_RTOL)


@pytest.fixture
def cuda():
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
    either side of the 64-row tile), both head dims, GQA groups of 4 and 8,
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
    a 1024-token table (4 partitions), through split and merge."""
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
        for o, r in zip(out, ssd_chunk_tiled_ref(*args)):
            torch.testing.assert_close(
                o, r, rtol=SSD_TILED_RTOL,
                atol=SSD_TILED_ATOL * float(r.abs().max()))


def _device_kernels(fn) -> set:
    """Names of the device kernels one call of ``fn`` ran, by the
    profiler (namespace, template arguments and parameters dropped)."""
    from torch.profiler import ProfilerActivity, profile
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
    """bf16 runs only the tensor-core kernels (every name ``ssd_chunk_``,
    none the CUDA-core one); f32 runs ``ssd_chunk_kernel`` alone."""
    g = torch.Generator(device=cuda).manual_seed(3)
    b, nc, Q, H, P, G, N = 1, 2, 256, 8, 64, 1, 128
    ran = {}
    for dtype in (torch.bfloat16, torch.float32):
        x, dt, A_log, B, C = _ssd_inputs(g, cuda, b, nc * Q, H, P, G, N, dtype)
        args = (x.view(b, nc, Q, H, P), dt.view(b, nc, Q, H), A_log,
                B.view(b, nc, Q, G, N), C.view(b, nc, Q, G, N))
        ssd_ops.ssd_chunk(*args)            # built and loaded before
        ran[dtype] = _device_kernels(lambda: ssd_ops.ssd_chunk(*args))
    assert ran[torch.bfloat16] and all(
        n.startswith("ssd_chunk_") for n in ran[torch.bfloat16])
    assert "ssd_chunk_kernel" not in ran[torch.bfloat16]
    assert ran[torch.float32] == {"ssd_chunk_kernel"}


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
    cfg = ModelConfig(name="gpu-small", family="dense", n_layers=2,
                      d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
                      vocab_size=512, head_dim=64)
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
