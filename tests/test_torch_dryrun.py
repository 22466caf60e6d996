"""The port's dry run: cells on meta DTensors (``launch/cells.py``), the
per-rank counter (``launch/op_count.py``), the dry run's command line and the
roofline (``launch/dryrun.py``, ``launch/roofline.py``), and the kernel
wrappers' meta branches.

* The twin of the JAX package's ``test_smoke_cells_compile_on_8_devices``:
  the same four smoke cells built and run on meta on a (2, 4) fake world,
  and counted.
* The counter counts per rank: a product whose contraction is split over
  all 8 ranks counts 1/8 of the whole, a replicated one the whole.
* The counter agrees with the closed forms: llama2-13b's training cut
  against ``llama2_train_flops``, and every smoke config's decode step (the
  encoder's prefill) against ``ModelConfig.active_param_count`` plus the
  products the analytic count leaves out, named family by family.

A fake world is one process's default process group, so every test that
makes one runs a subprocess of its own, with a time limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
TIMEOUT = 300


def _run(code: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code), *args],
                       capture_output=True, text=True, timeout=TIMEOUT,
                       env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


SMOKE_CELLS = """
    import json
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.dryrun import count_cell
    from repro_torch.launch.mesh import init_fake_world
    init_fake_world(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    for arch, shape in [("qwen3-4b", "train_4k"),
                        ("qwen3-4b", "decode_32k"),
                        ("recurrentgemma-9b", "decode_32k"),
                        ("phi3.5-moe-42b-a6.6b", "train_4k")]:
        cell = build_cell(arch, shape, mesh, smoke=True)
        counts = count_cell(cell)
        out = {"arch": arch, "shape": shape, "counts": counts,
               "params": {k: str(v.placements)
                          for k, v in cell.args[0].named_parameters()}}
        print("ROW " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def smoke_rows():
    rows = [json.loads(line[4:]) for line in _run(SMOKE_CELLS).splitlines()
            if line.startswith("ROW ")]
    return {(r["arch"], r["shape"]): r for r in rows}


def test_smoke_cells_run_on_meta_on_8_ranks(smoke_rows):
    """The four cells of the JAX twin build, run and count without
    error."""
    assert set(smoke_rows) == {("qwen3-4b", "train_4k"),
                               ("qwen3-4b", "decode_32k"),
                               ("recurrentgemma-9b", "decode_32k"),
                               ("phi3.5-moe-42b-a6.6b", "train_4k")}
    for r in smoke_rows.values():
        c = r["counts"]
        assert c["flops"] > 0 and c["traffic_bytes"] > 0
        assert c["collective_bytes"] > 0


def test_smoke_cells_place_and_launch_as_their_kind(smoke_rows):
    """Training shards weights over data (FSDP) and model (TP) and reaches
    no kernel wrapper; decode reaches the paged kernel, every full or
    local attention layer once; recurrentgemma's RG-LRU layers none."""
    train = smoke_rows[("qwen3-4b", "train_4k")]
    assert train["params"]["blocks.0.mixer.wq"] == \
        "(Shard(dim=0), Shard(dim=1))"
    assert train["counts"]["kernels"] == {}
    assert smoke_rows[("phi3.5-moe-42b-a6.6b", "train_4k")]["counts"][
        "kernels"] == {}
    dec = smoke_rows[("qwen3-4b", "decode_32k")]["counts"]["kernels"]
    assert dec["paged_attention"]["launches"] == 4        # 4 layers
    rg = smoke_rows[("recurrentgemma-9b", "decode_32k")]["counts"]["kernels"]
    assert rg["paged_attention"]["launches"] == 2   # 2 periods of 3 layers
    assert smoke_rows[("qwen3-4b", "decode_32k")]["params"][
        "blocks.0.mixer.wq"] == "(Replicate(), Shard(dim=1))"


PER_RANK = """
    import json, torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.distributed.spmd import spmd
    from repro_torch.launch.mesh import init_fake_world
    from repro_torch.launch.op_count import OpCounter
    init_fake_world(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    M, K, N = 256, 5120, 13824
    def count(px, pw):
        x = distribute_tensor(torch.empty(M, K, device="meta"), mesh, px,
                              src_data_rank=None)
        w = distribute_tensor(torch.empty(K, N, device="meta"), mesh, pw,
                              src_data_rank=None)
        with OpCounter() as c, spmd():
            y = x @ w
        return c.flops, [type(p).__name__ for p in y.placements]
    split = count([Shard(1), Shard(1)], [Shard(0), Shard(0)])
    rep = count([Replicate()] * 2, [Replicate()] * 2)
    print("ROW " + json.dumps({"split": split, "replicated": rep,
                               "whole": 2 * M * K * N}))
"""


@pytest.fixture(scope="module")
def per_rank():
    line = next(x for x in _run(PER_RANK).splitlines() if x.startswith("ROW "))
    return json.loads(line[4:])


def test_split_contraction_counts_one_eighth(per_rank):
    """(256, 5120) x (5120, 13824) with the contraction split over both
    mesh dims: each rank multiplies 1/8 of it (the output is a partial
    sum); FlopCounterMode would report the whole 3.62e10."""
    flops, placements = per_rank["split"]
    assert per_rank["whole"] == 36238786560
    assert flops == per_rank["whole"] / 8
    assert placements == ["Partial", "Partial"]


def test_replicated_product_counts_the_whole(per_rank):
    flops, placements = per_rank["replicated"]
    assert flops == per_rank["whole"]
    assert placements == ["Replicate", "Replicate"]


def test_llama2_training_cut_counted_equals_closed_form():
    """llama2-13b's card training cut (8 of 40 layers, 2 x 4096), counted
    on meta as it runs (no mesh), against ``llama2_train_flops``' executed
    figure: within 1% (the form counts the checkpoint's early stop)."""
    from repro_torch.launch.op_count import (OpCounter, llama2_train_flops,
                                             train_flops)
    from repro_torch.launch.serve import TRAIN_DEPTH_CUTS, card_config
    from repro_torch.models.model import init_params
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_loop import make_train_step
    cfg = card_config("llama2-13b", TRAIN_DEPTH_CUTS)
    params = init_params(cfg, None, device="meta")
    params.requires_grad_(True)
    B, S = 2, 4096
    batch = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    step = make_train_step(cfg, AdamWConfig(), remat=True)
    with OpCounter() as c:
        step(params, adamw_init(params), batch)
    _, executed, _ = llama2_train_flops(cfg, B, S)
    assert abs(c.flops - executed) <= 0.01 * executed
    assert train_flops(params, cfg, B, S) == llama2_train_flops(cfg, B, S)
    assert c.kernels == {}              # training reaches no kernel wrapper


def _analytic_extras(cfg, tokens: int) -> float:
    """Weights a token multiplies that ``active_param_count`` leaves out
    or counts otherwise, summed over the layers: MLA's rope query columns
    (d·H·rd); an SSM layer's depthwise conv and its state read (W·(di +
    2GN) + H·P·N); an RG-LRU layer's two (w, w) gates and its conv, where
    the count takes 3w (2w² + W·w − 3w)."""
    from repro_torch.models.transformer import layer_kinds
    d, H = cfg.d_model, cfg.n_heads
    extra = 0
    for kind in layer_kinds(cfg):
        if kind in ("attn", "local", "global") and cfg.use_mla:
            extra += d * H * cfg.rope_head_dim
        elif kind == "ssm":
            extra += (cfg.conv_width * (cfg.d_inner + 2 * cfg.ssm_groups
                                        * cfg.ssm_state)
                      + cfg.n_ssm_heads * cfg.ssm_head_dim * cfg.ssm_state)
        elif kind == "rglru":
            w = cfg.rnn_width
            extra += 2 * w * w + cfg.conv_width * w - 3 * w
    return extra


def _moe_rows_adjust(cfg, tokens: int) -> float:
    """Under ``dropping``, each MoE layer runs its experts over E·C
    capacity rows, not tokens·k: the difference in expert weights read,
    over all MoE layers, per token."""
    from repro_torch.models.moe import _capacity
    from repro_torch.models.transformer import layer_kinds
    if not cfg.n_experts:
        return 0.0
    per = 3 * cfg.d_model * cfg.moe_d_ff
    layers = sum(1 for i, k in enumerate(layer_kinds(cfg))
                 if i >= cfg.first_dense_layers and k != "ssm")
    C = _capacity(tokens, cfg)
    return layers * per * (cfg.n_experts * C - tokens * cfg.moe_top_k) / tokens


SMOKE_ARCHS = ["deepseek-v2-lite-16b", "gemma3-4b", "h2o-danube-1.8b",
               "hubert-xlarge", "internvl2-76b", "llama2-13b", "mamba2-370m",
               "minicpm3-4b", "phi3.5-moe-42b-a6.6b", "qwen3-4b",
               "recurrentgemma-9b"]


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_serve_matmul_flops_match_active_params(arch):
    """A smoke decode step (hubert: its prefill) on meta: the FLOPs of
    its products (aten mm and bmm; the attention kernels count apart)
    equal 2 · tokens · (``active_param_count`` − the embedding lookup +
    ``_analytic_extras`` + ``_moe_rows_adjust``)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.op_count import OpCounter
    from repro_torch.models.model import (decode_step, init_decode_caches,
                                          init_params, prefill)
    cfg = get_smoke_config(arch)
    params = init_params(cfg, None, device="meta", dtype=torch.bfloat16)
    B, S = 4, 32
    lookup = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    with OpCounter() as c:
        if cfg.is_encoder_only:
            prefill(params, {"embeddings": torch.empty(
                (B, S, cfg.d_model), dtype=torch.bfloat16, device="meta")},
                cfg)
            tokens = B * S
        else:
            caches = init_decode_caches(cfg, B, S, device="meta")
            decode_step(params, torch.empty((B, 1), dtype=torch.int32,
                                            device="meta"), caches, S - 1,
                        cfg)
            tokens = B
    counted = c.by_op.get("aten.mm", 0) + c.by_op.get("aten.bmm", 0)
    want = 2 * tokens * (cfg.active_param_count() - lookup
                         + _analytic_extras(cfg, tokens)
                         + _moe_rows_adjust(cfg, tokens))
    assert counted == pytest.approx(want, rel=1e-9), (counted, want)


def test_meta_kernel_branches_report_their_counts():
    """On meta tensors each wrapper returns its output's shape and type
    and reports the formulas ``chip_smoke.py``'s bounds use."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_counts)
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention, paged_attention_partials, paged_counts)
    from repro_torch.kernels.ssd_scan.ops import ssd_chunk, ssd_counts
    from repro_torch.launch.op_count import OpCounter
    meta = dict(device="meta", dtype=torch.bfloat16)
    q = torch.empty((2, 64, 8, 128), **meta)
    k = torch.empty((2, 64, 2, 128), **meta)
    with OpCounter() as c:
        out = flash_attention(q, k, k, causal=True, window=16)
        pq = torch.empty((2, 8, 128), **meta)
        pages = torch.empty((8, 16, 2, 128), **meta)
        table = torch.empty((2, 4), dtype=torch.int32, device="meta")
        lens = torch.empty((2,), dtype=torch.int32, device="meta")
        po = paged_attention(pq, pages, pages, table, lens)
        m, l, o = paged_attention_partials(pq, pages, pages, table, lens)
        x = torch.empty((1, 2, 64, 4, 16), **meta)
        f32 = dict(device="meta", dtype=torch.float32)
        ys = ssd_chunk(x, torch.empty((1, 2, 64, 4), **f32),
                       torch.empty((4,), **f32),
                       torch.empty((1, 2, 64, 1, 16), **meta),
                       torch.empty((1, 2, 64, 1, 16), **meta))
    assert out.shape == (2, 64, 8, 128) and out.dtype == torch.bfloat16
    # the partials keep the GPU's partitions, at least two
    assert po.shape == (2, 8, 128) and o.shape[:2] == (2, 8)
    assert o.shape[2] >= 2 and o.shape[3] == 128
    assert m.shape == l.shape == o.shape[:3]
    assert m.dtype == l.dtype == o.dtype == torch.float32
    assert [tuple(t.shape) for t in ys] == [(1, 2, 64, 4, 16),
                                           (1, 2, 4, 16, 16), (1, 2, 64, 4),
                                           (1, 2, 4)]
    f = c.kernels["flash_attention"]
    assert (f["flops"], f["bytes"]) == flash_counts(2, 64, 8, 2, 128, 2,
                                                    True, 16)
    p = c.kernels["paged_attention"]
    assert p["launches"] == 2
    assert (p["flops"], p["bytes"]) == tuple(
        2 * v for v in paged_counts(2, 8, 2, 128, 2, [64, 64]))
    s = c.kernels["ssd_chunk"]
    assert (s["flops"], s["bytes"]) == ssd_counts(1, 128, 4, 16, 1, 16, 64,
                                                  2)


def test_dryrun_cli_one_cell_and_roofline(tmp_path):
    """``launch/dryrun.py`` on qwen3-4b's decode_32k at full width on the
    (16, 16) mesh of 256 fake ranks, then ``launch/roofline.py`` over its
    row.  The sharded decode's collectives hold no cache-sized gather: the
    largest all-gather is the merge's B·H·(hd + 2) floats of 16 ranks."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "qwen3-4b", "--shape", "decode_32k",
                        "--out", str(tmp_path)], capture_output=True,
                       text=True, timeout=TIMEOUT, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    row = json.loads((tmp_path / "qwen3-4b__decode_32k__pod_16x16__base.json")
                     .read_text())
    assert row["status"] == "ok" and row["chips"] == 256
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-4b")
    B_l, S_l = 128 // 16, 32768 // 16
    cache_layer = B_l * S_l * cfg.n_kv_heads * cfg.head_dim * 2   # bf16 k
    gather = row["counts"]["collectives"]["all-gather"]
    merge = 16 * B_l * cfg.n_heads * (cfg.head_dim + 2) * 4
    assert gather["max_bytes"] <= max(merge, cfg.d_model * 2 * B_l * 16)
    assert gather["max_bytes"] < cache_layer / 10
    assert row["counts"]["kernels"]["paged_attention"]["launches"] == \
        cfg.n_layers
    assert row["model_flops"] == 2 * cfg.active_param_count() * 128
    t = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline",
                        "--out", str(tmp_path)], capture_output=True,
                       text=True, timeout=TIMEOUT, env=env)
    assert t.returncode == 0, t.stderr[-2000:]
    assert "| qwen3-4b | decode_32k |" in t.stdout
