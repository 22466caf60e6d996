"""The port's mesh and sharding (``launch/mesh.py``,
``distributed/sharding.py``, ``distributed/spmd.py``) and its
expert-parallel MoE (``models/moe.py::moe_ep_a2a``) against the JAX
package.

* Placements: for every arch, in both modes, on the (16, 16) and (2, 16,
  16) meshes, each parameter's per-dim axis tuple equals JAX's
  ``ShardingPolicy.param_spec`` for the bridged leaf (the stacked period dim
  dropped), and so do the decode caches, batches and logits at the cells'
  shapes.  JAX runs on ``jax.sharding.AbstractMesh``; the port on
  ``launch.mesh.AbstractMesh``.  No process group is made.
* Sharded equals single-process: 4 gloo ranks on a (2, 2) mesh run
  qwen3-4b's smoke config on DTensors, a train step (its gradients and its
  updated weights) and a prefill with 4 decode steps over a
  sequence-sharded cache, against the same code on plain tensors in f32;
  and the same prefill and decode for the MLA configs (minicpm3-4b,
  deepseek-v2-lite-16b), whose one latent cache is split along its
  sequence.
* ``ep_a2a``: phi3.5's smoke MoE layer on 4 gloo ranks against JAX's
  ``moe_ep_a2a`` on 4 forced host devices in a subprocess, on a batch where
  pairs drop.

Rank processes run this file as a script (``python
tests/test_torch_sharding.py <job> <rank> <world> <store> <out>``); they
meet through a ``FileStore`` under the test's ``tmp_path``, and each test
kills its ranks at its own time limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
RANK_TIMEOUT = 240          # seconds, for every rank of one test


# ---------------------------------------------------------------------------
# rank side
# ---------------------------------------------------------------------------

def _init_ranks(rank: int, world: int, store: str):
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world)


def _save(out: str, name: str, **arrays) -> None:
    np.savez(os.path.join(out, f"{name}.npz"),
             **{k: np.asarray(v) for k, v in arrays.items()})


def _serve(cfg, mesh, seed: int, tokens, out: str, name: str,
           rank: int) -> None:
    """A prefill of ``tokens`` and 4 greedy decode steps over slot caches
    of 32 positions, on plain tensors and on DTensors under the serve
    policy (the caches' sequence over "model", so that each "model" rank
    holds 16 of the 32 positions), in f32; rank 0 saves both runs' logits
    and the first layer's cache as ``<name>.npz``.  The DTensor run is fed
    the plain run's tokens, so that every step compares like with like."""
    import torch
    from repro_torch.distributed.sharding import (
        ShardingPolicy, batch_axes_for, distribute_batch, distribute_caches,
        distribute_params)
    from repro_torch.distributed.spmd import spmd
    from repro_torch.models.common import DtypePolicy
    from repro_torch.models.model import (decode_step, init_decode_caches,
                                          init_params, prefill)

    f32 = DtypePolicy(torch.float32, torch.float32, torch.float32)
    B, S = tokens.shape
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cpu")
    s_max, steps = 32, 4
    logits, caches = prefill(params, {"tokens": tokens}, cfg, policy=f32)
    full = init_decode_caches(cfg, B, s_max, dtype=torch.float32, device="cpu")
    for c, p in zip(full, caches):
        for k in c:
            c[k][:, :S] = p[k]
    sharded = [{k: t.clone() for k, t in c.items()} for c in full]
    ref_logits, toks = [logits[:, 0].numpy().copy()], []
    tok = logits.argmax(-1).int()
    for i in range(steps):
        toks.append(tok)
        logits, full = decode_step(params, tok, full, S + i, cfg, policy=f32)
        ref_logits.append(logits[:, 0].numpy().copy())
        tok = logits.argmax(-1).int()

    pol = ShardingPolicy(mesh, "serve", cfg, batch_axes=batch_axes_for(mesh))
    dp = distribute_params(params, pol)
    got_logits = []
    with spmd():
        lg, _ = prefill(dp, distribute_batch({"tokens": tokens}, pol),
                        cfg, policy=f32)
        got_logits.append(lg.full_tensor()[:, 0].numpy())
        dc = distribute_caches(sharded, pol)
        key = next(iter(dc[0]))
        cache_pl = str(dc[0][key].placements)
        local_len = dc[0][key].to_local().shape[1]
        for i in range(steps):
            t = distribute_batch({"t": toks[i]}, pol)["t"]
            lg, dc = decode_step(dp, t, dc, S + i, cfg, policy=f32)
            got_logits.append(lg.full_tensor()[:, 0].numpy())
        kv = dc[0][key].full_tensor().numpy()
    if rank == 0:
        _save(out, name, ref=np.stack(ref_logits), got=np.stack(got_logits),
              ref_k=full[0][key].numpy(), got_k=kv, local_len=local_len)
        Path(out, f"{name}_cache_placement.txt").write_text(cache_pl)


def job_qwen3(rank: int, world: int, out: str) -> None:
    """A train step, then a prefill and 4 decode steps, of qwen3-4b's smoke
    config on DTensors over a (2, 2) mesh, beside the same on plain
    tensors."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import (
        ShardingPolicy, batch_axes_for, distribute_batch,
        distribute_opt_state, distribute_params)
    from repro_torch.distributed.spmd import spmd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import DtypePolicy
    from repro_torch.models.model import init_params
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_loop import make_train_step

    torch.manual_seed(0)
    mesh = make_host_mesh(2, device_type="cpu")
    cfg = get_smoke_config("qwen3-4b")
    f32 = DtypePolicy(torch.float32, torch.float32, torch.float32)
    baxes = batch_axes_for(mesh)
    rng = np.random.default_rng(7)
    B, S = 4, 16
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    batch = {"tokens": tokens.int(), "labels": labels.int()}

    # train: plain, then on DTensors; each run's gradients first (the
    # step's own loss_and_grads), then the step.  Adam's eps is 1.0: at
    # 1e-8 the first step's update g / (|g| + eps) is a sign for every
    # gradient above 1e-8, and it turns the sharded sums' other rounding
    # order (gradients ~1e-6 of their scale apart) into weights up to
    # ~2e-5 apart, as the card's training parity found
    # (tests/test_torch_gpu.py); the gradients are held leaf by leaf
    step = make_train_step(cfg, AdamWConfig(warmup_steps=1, eps=1.0),
                           remat=True, policy=f32)
    params = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    params.requires_grad_(True)
    _, ref_g = step.loss_and_grads(params, batch)
    ref_g = {f"g.{k}": v.numpy().copy() for k, v in ref_g.items()}
    ref_p, _, ref_m = step(params, adamw_init(params), batch)
    ref = {k: v.detach().numpy().copy() for k, v in ref_p.named_parameters()}
    pol = ShardingPolicy(mesh, "train", cfg, batch_axes=baxes)
    params = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    params.requires_grad_(True)
    dp = distribute_params(params, pol)
    dopt = distribute_opt_state(adamw_init(params), pol)
    with spmd():
        dbatch = distribute_batch(batch, pol)
        _, got_g = step.loss_and_grads(dp, dbatch)
        got_g = {f"g.{k}": v.full_tensor().numpy()
                 for k, v in got_g.items()}
        new_p, _, met = step(dp, dopt, dbatch)
        got = {k: v.full_tensor().detach().numpy()
               for k, v in new_p.named_parameters()}
        loss = met["loss"].full_tensor().item()
        gnorm = met["grad_norm"].full_tensor().item()
    placements = {k: str(v.placements) for k, v in dp.named_parameters()}
    if rank == 0:
        _save(out, "train_ref", loss=ref_m["loss"].item(),
              grad_norm=ref_m["grad_norm"].item(), **ref, **ref_g)
        _save(out, "train_got", loss=loss, grad_norm=gnorm, **got, **got_g)
        Path(out, "placements.json").write_text(json.dumps(placements))

    _serve(cfg, mesh, 4, tokens.int(), out, "serve", rank)


def job_mla(rank: int, world: int, out: str) -> None:
    """A prefill and 4 decode steps of minicpm3-4b's and
    deepseek-v2-lite-16b's smoke configs (MLA: one latent slot cache
    ``"ckv"``, decoded through ``sharded_decode`` with ``hd_v`` the latent
    rank) on DTensors over a (2, 2) mesh, beside the same on plain
    tensors."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(2, device_type="cpu")
    for seed, arch in enumerate(MLA_ARCHS):
        cfg = get_smoke_config(arch)
        rng = np.random.default_rng(20 + seed)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)))
        _serve(cfg, mesh, 30 + seed, tokens.int(), out,
               f"serve_{arch.split('-')[0]}", rank)


def job_ep_a2a(rank: int, world: int, out: str) -> None:
    """phi3.5's smoke MoE layer through ``ep_a2a`` on a (2, 2) mesh, the
    weights and tokens JAX's (``ep_a2a_jax.npz``)."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import (ShardingPolicy,
                                                  batch_axes_for)
    from repro_torch.distributed.spmd import spmd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.moe import MoECtx, moe_forward

    mesh = make_host_mesh(2, device_type="cpu")
    cfg = get_smoke_config(EP_ARCH)
    d = np.load(os.path.join(out, "ep_a2a_jax.npz"))
    pol = ShardingPolicy(mesh, "serve", cfg, batch_axes=batch_axes_for(mesh))
    params = {k: pol.distribute(torch.from_numpy(d[k]),
                                pol.param_spec(k, d[k].shape))
              for k in ("router", "w_gate", "w_up", "w_down")}
    x = torch.from_numpy(d["x"])
    ctx = MoECtx("ep_a2a", mesh, batch_axes_for(mesh))
    with spmd():
        y, (probs, idx) = moe_forward(
            params, pol.distribute(x, pol.batch_spec(tuple(x.shape))), cfg,
            impl=ctx)
        y = y.full_tensor().numpy()
        placed = str(params["w_gate"].placements)
    if rank == 0:
        _save(out, "ep_a2a_port", y=y)
        Path(out, "ep_placement.txt").write_text(placed)


def job_dropping(rank: int, world: int, out: str) -> None:
    """The MoE layers of phi3.5's and deepseek's smoke configs under
    ``dropping`` on DTensors over a (2, 2) mesh (``moe_dropping_sharded``)
    and on plain tensors: outputs and every input's gradient, on skewed
    tokens whose pairs overflow the whole batch's capacity."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import (ShardingPolicy,
                                                  batch_axes_for)
    from repro_torch.distributed.spmd import spmd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.moe import _capacity, _route, init_moe, \
        moe_forward

    mesh = make_host_mesh(2, device_type="cpu")
    res = {}
    for arch in ("phi3.5-moe-42b-a6.6b", "deepseek-v2-lite-16b"):
        cfg = get_smoke_config(arch)
        flat = {}
        p = init_moe(torch.Generator().manual_seed(9), cfg, torch.float32,
                     "cpu")
        for key, v in p.items():
            if isinstance(v, dict):
                flat.update({f"shared.{k2}": t for k2, t in v.items()})
            else:
                flat[key] = v
        rng = np.random.default_rng(12)
        base = rng.standard_normal((1, 1, cfg.d_model))
        x = torch.from_numpy((base + 0.3 * rng.standard_normal(
            (4, 24, cfg.d_model))).astype(np.float32))
        _, idx, _ = _route(x.reshape(-1, cfg.d_model), p["router"],
                           cfg.moe_top_k)
        counts = np.bincount(idx.reshape(-1).numpy(),
                             minlength=cfg.n_experts)
        dropped = int(np.maximum(counts - _capacity(96, cfg), 0).sum())

        def run(weights, xin):
            params = {k: v for k, v in weights.items() if "." not in k}
            if any("." in k for k in weights):
                params["shared"] = {k.split(".")[1]: v
                                    for k, v in weights.items() if "." in k}
            y, (probs, _) = moe_forward(params, xin, cfg, impl="dropping")
            loss = (y.float() ** 2).sum() + probs.sum()
            names = list(weights)
            grads = torch.autograd.grad(
                loss, [xin] + [weights[k] for k in names])
            return y, dict(zip(["x"] + names, grads))

        ref_w = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
        ref_x = x.clone().requires_grad_(True)
        y_ref, g_ref = run(ref_w, ref_x)
        pol = ShardingPolicy(mesh, "train", cfg,
                             batch_axes=batch_axes_for(mesh))
        dw = {k: pol.distribute(v, pol.param_spec(k, v.shape))
              .requires_grad_(True) for k, v in flat.items()}
        dx = pol.distribute(x, pol.batch_spec(tuple(x.shape))) \
            .requires_grad_(True)
        with spmd():
            y, g = run(dw, dx)
            y = y.full_tensor().detach().numpy()
            g = {k: t.full_tensor().numpy() for k, t in g.items()}
        res[arch] = (y, g, y_ref.detach().numpy(),
                     {k: t.numpy() for k, t in g_ref.items()}, dropped)
    if rank == 0:
        for arch, (y, g, yr, gr, dropped) in res.items():
            tag = arch.split("-")[0]
            _save(out, f"dropping_{tag}", y=y, y_ref=yr, dropped=dropped,
                  **{f"g_{k}": v for k, v in g.items()},
                  **{f"r_{k}": v for k, v in gr.items()})


def job_kv_slice(rank: int, world: int, out: str) -> None:
    """qwen3-4b's smoke config with one KV head (4 query heads on it) on a
    (2, 2) mesh: the query heads split over "model", the KV head whole on
    each rank, which reads the slice its heads need
    (``spmd.local_heads``): the prefill's logits and the training loss's
    gradients against the plain run."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import (ShardingPolicy,
                                                  batch_axes_for,
                                                  distribute_batch,
                                                  distribute_params)
    from repro_torch.distributed.spmd import spmd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import DtypePolicy
    from repro_torch.models.model import init_params, prefill, train_loss

    mesh = make_host_mesh(2, device_type="cpu")
    cfg = get_smoke_config("qwen3-4b").scaled(n_kv_heads=1)
    f32 = DtypePolicy(torch.float32, torch.float32, torch.float32)
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)))
             .int() for k in ("tokens", "labels")}
    params = init_params(cfg, torch.Generator().manual_seed(6), device="cpu")
    ref_logits, _ = prefill(params, {"tokens": batch["tokens"]}, cfg,
                            policy=f32)
    params.requires_grad_(True)
    names = [n for n, _ in params.named_parameters()]
    ref = torch.autograd.grad(train_loss(params, batch, cfg, policy=f32),
                              list(params.parameters()))
    res = {}
    for mode in ("serve", "train"):
        pol = ShardingPolicy(mesh, mode, cfg, batch_axes=batch_axes_for(mesh))
        dp = distribute_params(params, pol)
        with spmd():
            db = distribute_batch(batch, pol)
            if mode == "serve":
                with torch.no_grad():
                    lg, _ = prefill(dp, {"tokens": db["tokens"]}, cfg,
                                    policy=f32)
                res["logits"] = lg.full_tensor().numpy()
            else:
                g = torch.autograd.grad(train_loss(dp, db, cfg, policy=f32),
                                        list(dp.parameters()))
                res.update({f"g_{n}": t.full_tensor().numpy()
                            for n, t in zip(names, g)})
    if rank == 0:
        _save(out, "kv_slice", ref_logits=ref_logits.numpy(),
              **{f"r_{n}": t.numpy() for n, t in zip(names, ref)}, **res)


JOBS = {"qwen3": job_qwen3, "ep_a2a": job_ep_a2a, "dropping": job_dropping,
        "kv_slice": job_kv_slice, "mla": job_mla}
MLA_ARCHS = ("minicpm3-4b", "deepseek-v2-lite-16b")
EP_ARCH = "phi3.5-moe-42b-a6.6b"
EP_JAX = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.models.moe import (_capacity, _route, init_moe, moe_dropping,
                              moe_ep_a2a)
cfg = get_smoke_config("phi3.5-moe-42b-a6.6b")
p = init_moe(jax.random.PRNGKey(5), cfg, jnp.float32)
rng = np.random.default_rng(11)
B, S, d = 4, 24, cfg.d_model
base = rng.standard_normal((1, 1, d))
x = (base + 0.3 * rng.standard_normal((B, S, d))).astype(np.float32)
mesh = jax.make_mesh((2, 2), ("data", "model"))
y_ep, _ = moe_ep_a2a(p, jnp.asarray(x), cfg, mesh, batch_axes=("data",))
y_drop, _ = moe_dropping(p, jnp.asarray(x), cfg)
_, idx, _ = _route(jnp.asarray(x.reshape(-1, d)), p["router"], cfg.moe_top_k)
np.savez(sys.argv[1], x=x, y_ep=np.asarray(y_ep), y_drop=np.asarray(y_drop),
         idx=np.asarray(idx), c_local=_capacity(B * S // 2, cfg),
         c_global=_capacity(B * S, cfg),
         **{k: np.asarray(v) for k, v in p.items()})
"""


def rank_main(argv) -> None:
    job, rank, world, store, out = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, str(SRC))
    _init_ranks(rank, world, store)
    import torch.distributed as dist
    try:
        JOBS[job](rank, world, out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# test side
# ---------------------------------------------------------------------------

def run_ranks(job: str, world: int, tmp_path: Path,
              timeout: float = RANK_TIMEOUT) -> Path:
    """Run ``job`` on ``world`` rank processes; fail the test if a rank
    fails or any outlives ``timeout``."""
    out = tmp_path / job
    out.mkdir()
    return run_ranks_in(job, world, tmp_path, out, timeout)


def run_ranks_in(job: str, world: int, tmp_path: Path, out: Path,
                 timeout: float = RANK_TIMEOUT) -> Path:
    """:func:`run_ranks` with the ranks' output directory ``out``."""
    store = tmp_path / f"{job}.store"
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, __file__, job, str(r), str(world), str(store),
         str(out)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=timeout)
            logs.append(text)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"rank job {job!r} outlived {timeout} s")
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, f"ranks {bad} failed:\n" + "\n".join(
        logs[r][-3000:] for r, _ in bad)
    return out


# ---- placements against JAX's rules ----------------------------------------

ARCHS = ["deepseek-v2-lite-16b", "gemma3-4b", "h2o-danube-1.8b",
         "hubert-xlarge", "internvl2-76b", "llama2-13b", "mamba2-370m",
         "minicpm3-4b", "phi3.5-moe-42b-a6.6b", "qwen3-4b",
         "recurrentgemma-9b"]
MESHES = {"pod_16x16": ((16, 16), ("data", "model")),
          "multipod_2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "idx", k)))


def _jax_leaves(tree) -> dict:
    import jax
    return {"/".join(_key(k) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_layer_prefix(cfg, i: int) -> str:
    """Path of layer i in the JAX stack layout (bridge.layers_from_tree)."""
    from repro_torch.models.transformer import stack_layout
    head, n_periods, _ = stack_layout(cfg)
    period = len(cfg.pattern)
    if i < head:
        return f"head/{i}"
    if i < head + n_periods * period:
        return f"stack/slot_{(i - head) % period}"
    return f"tail/{i - head - n_periods * period}"


def _jax_param_path(cfg, name: str) -> str:
    parts = name.split(".")
    if parts[0] != "blocks":
        return name
    rest = parts[2:]
    if rest[0] == "shared":                    # under mlp in JAX
        rest = ["mlp", "shared"] + rest[1:]
    return "/".join(["blocks", _jax_layer_prefix(cfg, int(parts[1]))] + rest)


def _policies(arch: str, mode: str, mesh_name: str):
    import jax.sharding
    from repro.configs import get_config as jax_config
    from repro.distributed import sharding as jsh
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as tsh
    from repro_torch.launch.mesh import AbstractMesh
    shape, names = MESHES[mesh_name]
    jmesh = jax.sharding.AbstractMesh(shape, names)
    tmesh = AbstractMesh(shape, names)
    jpol = jsh.ShardingPolicy(jmesh, mode, jax_config(arch),
                              batch_axes=jsh.batch_axes_for(jmesh))
    tpol = tsh.ShardingPolicy(tmesh, mode, get_config(arch),
                              batch_axes=tsh.batch_axes_for(tmesh))
    return jpol, tpol


def _drop_lead(path: str, spec: tuple) -> tuple:
    stacked = path.startswith("stack/") or "/stack/" in path
    assert not stacked or spec[0] is None
    return spec[1:] if stacked else spec


CASES = [(a, m, n) for a in ARCHS for m in ("train", "serve") for n in MESHES]


@pytest.mark.parametrize("arch,mode,mesh_name", CASES)
def test_placements_equal_jax(arch, mode, mesh_name):
    """Every parameter's spec, the decode caches', the batches' and the
    logits' at the cells' shapes, against JAX's rules."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.models.model import init_decode_caches as jax_caches
    from repro.models.model import init_params as jax_params
    from repro_torch.models.model import init_decode_caches, init_params
    jpol, tpol = _policies(arch, mode, mesh_name)
    cfg = tpol.cfg
    jleaves = _jax_leaves(jax.eval_shape(
        lambda k: jax_params(k, jpol.cfg), jax.random.PRNGKey(0)))
    params = init_params(cfg, None, device="meta")
    names = [n for n, _ in params.named_parameters()]
    seen = set()
    for name, p in params.named_parameters():
        path = _jax_param_path(cfg, name)
        jshape = jleaves[path]
        stacked = "/stack/" in path
        assert tuple(jshape[1:] if stacked else jshape) == tuple(p.shape), name
        want = _drop_lead(path, tuple(jpol.param_spec(path, jshape)))
        assert tpol.param_spec(name, tuple(p.shape)) == want, (name, want)
        seen.add(path)
    assert seen == set(jleaves), set(jleaves) ^ seen
    assert len(names) == sum(1 for _ in params.parameters())

    # decode caches at decode_32k's and long_500k's shapes
    if not cfg.is_encoder_only:
        for B, S in ((128, 32768), (1, 524288)):
            jc = _jax_leaves(jax.eval_shape(
                lambda: jax_caches(jpol.cfg, B, S, dtype=jnp.bfloat16)))
            tc = init_decode_caches(cfg, B, S, device="meta")
            for i, layer in enumerate(tc):
                pre = _jax_layer_prefix(cfg, i)
                for k, t in layer.items():
                    got = tpol.cache_spec(k, tuple(t.shape))
                    jname = "latent" if k == "ckv" else k
                    path = f"{pre}/{jname}"
                    want = _drop_lead(path, tuple(jpol.cache_spec(
                        path, jc[path])))
                    if k == "ckv":      # (B,S,1,r+rd) against (B,S,r)
                        assert got[:2] == want[:2] and got[2] is None, path
                        assert got[3] == tpol._ax("model", t.shape[3]) \
                            if want[1] is None else got[3] is None
                    else:
                        assert got == want, (path, got, want)
    # batches and logits at the cells' shapes
    for shape in ((256, 4096), (32, 32768), (128, 1), (1, 1),
                  (32, 32768, cfg.d_model)):
        assert tpol.batch_spec(shape) == tuple(
            jpol.batch_shardings(jax.ShapeDtypeStruct(shape, jnp.int32))
            .spec) + (None,) * (len(shape) - len(jpol.batch_shardings(
                jax.ShapeDtypeStruct(shape, jnp.int32)).spec))
    for B in (256, 32, 128, 1):
        shape = (B, 1, cfg.vocab_size)
        want = tuple(jpol.logits_sharding(shape).spec)
        assert tpol.logits_spec(shape) == want


def test_placements_of_a_spec():
    """Axis names to DTensor placements: a tuple shards one dim over each
    of its mesh dims, pod-major; others replicate."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.launch.mesh import AbstractMesh
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    pol = ShardingPolicy(mesh, "train", get_config("qwen3-4b"),
                         batch_axes=("pod", "data"))
    assert pol.placements((("pod", "data"), None)) == [
        Shard(0), Shard(0), Replicate()]
    assert pol.placements((None, "model")) == [
        Replicate(), Replicate(), Shard(1)]
    assert pol.placements(("data", "model")) == [
        Replicate(), Shard(0), Shard(1)]
    # minicpm3's and mamba2's vocabularies do not divide: replicated
    for arch in ("minicpm3-4b", "mamba2-370m"):
        cfg = get_config(arch)
        p = ShardingPolicy(mesh, "serve", cfg, batch_axes=("pod", "data"))
        assert p.param_spec("embed", (cfg.vocab_size, cfg.d_model))[0] is None


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


TOL = 1e-5


@pytest.fixture(scope="module")
def qwen3_ranks(tmp_path_factory):
    return run_ranks("qwen3", 4, tmp_path_factory.mktemp("qwen3"))


def test_sharded_train_step_equals_single_process(qwen3_ranks):
    ref = np.load(qwen3_ranks / "train_ref.npz")
    got = np.load(qwen3_ranks / "train_got.npz")
    assert abs(float(got["loss"]) - float(ref["loss"])) <= TOL * abs(
        float(ref["loss"]))
    assert abs(float(got["grad_norm"]) - float(ref["grad_norm"])) <= TOL * abs(
        float(ref["grad_norm"]))
    names = [k for k in ref.files if k not in ("loss", "grad_norm")
             and not k.startswith("g.")]
    assert len(names) > 10
    for k in names:
        assert _rel(got[k], ref[k]) <= TOL, k


def test_sharded_train_gradients_equal_single_process(qwen3_ranks):
    """Every gradient leaf of the train step on DTensors (reduced onto its
    weight's placements) within 1e-5 of its own scale of the plain
    step's: the weights' check at Adam eps 1.0 sees a leaf's gradient only
    through lr·g, so each leaf is held here."""
    ref = np.load(qwen3_ranks / "train_ref.npz")
    got = np.load(qwen3_ranks / "train_got.npz")
    names = [k for k in ref.files if k.startswith("g.")]
    assert len(names) > 10 and set(names) == {
        k for k in got.files if k.startswith("g.")}
    for k in names:
        assert np.max(np.abs(ref[k])) > 0, k
        assert _rel(got[k], ref[k]) <= TOL, k


def test_sharded_train_weights_are_placed(qwen3_ranks):
    pl = json.loads((qwen3_ranks / "placements.json").read_text())
    # train: FSDP rows over data, heads over model
    assert pl["blocks.0.mixer.wq"] == "(Shard(dim=0), Shard(dim=1))"
    assert pl["blocks.0.mixer.wo"] == "(Shard(dim=1), Shard(dim=0))"
    assert pl["final_norm"] == "(Replicate(), Replicate())"


def test_sharded_prefill_and_decode_equal_single_process(qwen3_ranks):
    d = np.load(qwen3_ranks / "serve.npz")
    assert d["got"].shape == d["ref"].shape == (5, 4, 256)
    for i in range(5):
        assert _rel(d["got"][i], d["ref"][i]) <= TOL, i
    assert _rel(d["got_k"], d["ref_k"]) <= TOL


def _dropped(idx: np.ndarray, C: int) -> int:
    """(token, choice) pairs ranked at or past capacity C in their expert,
    in token-major order."""
    counts: dict = {}
    dropped = 0
    for e in idx.reshape(-1):
        counts[e] = counts.get(e, 0) + 1
        dropped += counts[e] > C
    return dropped


def test_ep_a2a_equals_jax_moe_ep_a2a(tmp_path):
    """phi3.5's smoke MoE layer (4 experts, top 2) on a (2, 2) mesh: 4
    gloo ranks against JAX's ``moe_ep_a2a`` on 4 forced host devices, on
    skewed tokens whose pairs overflow the local capacity; and not equal
    to ``dropping``, whose capacity counts the whole batch."""
    out = tmp_path / "ep_a2a"
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", EP_JAX,
                        str(out / "ep_a2a_jax.npz")], env=env,
                       capture_output=True, text=True, timeout=RANK_TIMEOUT)
    assert r.returncode == 0, r.stderr[-3000:]
    run_ranks_in("ep_a2a", 4, tmp_path, out)
    j = np.load(out / "ep_a2a_jax.npz")
    got = np.load(out / "ep_a2a_port.npz")["y"]
    assert _rel(got, j["y_ep"]) <= 2e-5
    # every data rank routes 48 tokens at its own capacity: some drop there
    idx = j["idx"].reshape(2, -1, j["idx"].shape[-1])
    assert sum(_dropped(i, int(j["c_local"])) for i in idx) > 0
    assert _rel(j["y_drop"], j["y_ep"]) > 1e-2
    assert (out / "ep_placement.txt").read_text() == \
        "(Replicate(), Shard(dim=0))"


@pytest.fixture(scope="module")
def dropping_ranks(tmp_path_factory):
    return run_ranks("dropping", 4, tmp_path_factory.mktemp("dropping"))


@pytest.mark.parametrize("tag", ["phi3.5", "deepseek"])
def test_sharded_dropping_equals_single_process(dropping_ranks, tag):
    """``dropping`` on DTensors (tokens over data, experts over model,
    FSDP rows over data) keeps the single program's global capacity: the
    output and the gradients of the tokens, the router and every expert
    weight (deepseek's shared experts too) equal the plain layer's, on a
    batch where pairs drop."""
    d = np.load(dropping_ranks / f"dropping_{tag}.npz")
    assert int(d["dropped"]) > 0
    assert _rel(d["y"], d["y_ref"]) <= TOL
    names = [k[2:] for k in d.files if k.startswith("g_")]
    assert {"x", "router", "w_gate", "w_up", "w_down"} <= set(names)
    for k in names:
        assert _rel(d[f"g_{k}"], d[f"r_{k}"]) <= TOL, k


def test_query_heads_split_over_one_kv_head(tmp_path):
    """Four query heads on one KV head over 2 "model" ranks: each rank
    runs its two query heads against the KV head (the flash plain version
    in prefill, the training attention in the loss); logits and every
    gradient equal the plain run's."""
    d = np.load(run_ranks("kv_slice", 4, tmp_path) / "kv_slice.npz")
    assert _rel(d["logits"], d["ref_logits"]) <= TOL
    names = [k[2:] for k in d.files if k.startswith("r_")]
    assert "blocks.0.mixer.wk" in names
    for k in names:
        assert _rel(d[f"g_{k}"], d[f"r_{k}"]) <= TOL, k


def test_decode_cache_sequence_is_sharded(qwen3_ranks):
    assert ((qwen3_ranks / "serve_cache_placement.txt").read_text()
            == "(Shard(dim=0), Shard(dim=1))")
    assert int(np.load(qwen3_ranks / "serve.npz")["local_len"]) == 16


@pytest.fixture(scope="module")
def mla_ranks(tmp_path_factory):
    return run_ranks("mla", 4, tmp_path_factory.mktemp("mla"))


@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_sharded_mla_decode_equals_single_process(mla_ranks, arch):
    """MLA over a latent cache whose sequence is split over the 2 "model"
    ranks (16 of 32 positions each): the prefill's and every decode
    step's logits, and the written cache, equal the plain run's."""
    tag = arch.split("-")[0]
    d = np.load(mla_ranks / f"serve_{tag}.npz")
    assert ((mla_ranks / f"serve_{tag}_cache_placement.txt").read_text()
            == "(Shard(dim=0), Shard(dim=1))")
    assert int(d["local_len"]) == 16
    assert d["got"].shape == d["ref"].shape and d["got"].shape[0] == 5
    for i in range(5):
        assert _rel(d["got"][i], d["ref"][i]) <= TOL, i
    assert _rel(d["got_k"], d["ref_k"]) <= TOL


if __name__ == "__main__":
    rank_main(sys.argv[1:])
