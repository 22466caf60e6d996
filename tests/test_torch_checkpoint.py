"""The port's checkpoint/restart on the CPU: the ports of
``tests/test_checkpoint.py``, a port checkpoint's manifest against a JAX
checkpoint of the same bridged state (and a JAX checkpoint restored into
the port), the optimizer-state bridge, and the training launcher's
crash-and-restart flow (``examples/train_tiny_lm.py``'s) against a straight
run."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_smoke_config as jax_smoke
from repro.models import init_params as jax_init
from repro.training import adamw_init as jax_adamw_init
from repro_torch import bridge
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_smoke_config
from repro_torch.launch.train import main as train_main
from repro_torch.training import (AdamWConfig, DataConfig, TokenDataset,
                                  batch_to, init_train_state,
                                  make_train_step)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this file, restored after it.  The
    suite runs files in parallel workers on shared cores, where the many
    small ops of a training step in several threads each spin against one
    another (this file ran ~10x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_atomic_and_gc(tmp_path):
    tree = {"w": torch.ones((4, 4))}
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(tmp_path, s, tree, keep=2)
    assert latest_step(tmp_path) == 5
    kept = sorted(p.name for p in tmp_path.iterdir())
    assert len(kept) == 2
    (tmp_path / "step_000000009.tmp").mkdir()     # a save cut short
    assert latest_step(tmp_path) == 5


def test_restore_validates_shapes(tmp_path):
    save_checkpoint(tmp_path, 1, {"w": torch.ones((4, 4))})
    target = {"w": torch.zeros((2, 2))}
    with pytest.raises(ValueError, match="leaf 0"):
        restore_checkpoint(tmp_path, target)
    with pytest.raises(ValueError, match="leaf count"):
        restore_checkpoint(tmp_path, {"w": torch.zeros((4, 4)),
                                      "b": torch.zeros(4)})
    assert not target["w"].any()                  # nothing was written


def test_leaves_restore_on_the_target_dtype_bitwise(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
            "f32": torch.randn(7, generator=g), "step": torch.tensor(
                3, dtype=torch.int32), "np": np.arange(4, dtype=np.int64)}
    d = save_checkpoint(tmp_path, 1, tree)
    dtypes = [leaf["dtype"] for leaf in
              json.loads((d / "manifest.json").read_text())["leaves"]]
    assert dtypes == ["bfloat16", "float32", "int64", "int32"]
    like = {"bf16": torch.zeros(3, 5, dtype=torch.bfloat16),
            "f32": torch.zeros(7), "step": torch.tensor(0, dtype=torch.int32),
            "np": np.zeros(4, dtype=np.int64)}
    out, step, _ = restore_checkpoint(tmp_path, like)
    assert step == 1 and out["bf16"] is like["bf16"]
    for k in ("bf16", "f32", "step"):
        assert torch.equal(out[k], tree[k])
    np.testing.assert_array_equal(out["np"], tree["np"])


def test_train_resume_equivalence(tmp_path):
    """train(4 steps) == train(2) + save + restore + train(2), bitwise."""
    cfg = get_smoke_config("llama2-13b")
    opt_cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=4)
    step_fn = make_train_step(cfg, opt_cfg, remat=False)

    def batches():
        return TokenDataset(cfg, DataConfig(global_batch=2,
                                            seq_len=32)).batches()

    p1, o1 = init_train_state(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    it = batches()
    for _ in range(4):
        p1, o1, _ = step_fn(p1, o1, batch_to(next(it), "cpu"))

    p2, o2 = init_train_state(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    it = batches()
    for _ in range(2):
        p2, o2, _ = step_fn(p2, o2, batch_to(next(it), "cpu"))
    save_checkpoint(tmp_path, 2, bridge.train_state_tree(p2, o2, cfg))
    # restore into a fresh state, as a restarted process would
    p2, o2 = init_train_state(cfg, torch.Generator().manual_seed(1),
                              device="cpu")
    _, step, _ = restore_checkpoint(tmp_path,
                                    bridge.train_state_tree(p2, o2, cfg))
    assert step == 2 and int(o2.step) == 2
    for _ in range(2):
        p2, o2, _ = step_fn(p2, o2, batch_to(next(it), "cpu"))

    for a, b in zip(p1.parameters(), p2.parameters()):
        assert torch.equal(a, b)
    for k in o1.m:
        assert torch.equal(o1.m[k], o2.m[k]) and torch.equal(o1.v[k], o2.v[k])


def test_scheduler_state_in_checkpoint(tmp_path):
    from repro_torch.core import EWSJFConfig, EWSJFScheduler, Request
    s = EWSJFScheduler(EWSJFConfig(min_history=8))
    for ln in (32, 64, 2048, 4096):
        s.submit(Request(prompt_len=ln), now=0.0)
    s.maybe_reoptimize(1.0, force=True)
    save_checkpoint(tmp_path, 7, {"x": torch.zeros(1)},
                    scheduler_state=s.state_dict())
    _, _, sched_state = restore_checkpoint(tmp_path, {"x": torch.zeros(1)})
    s2 = EWSJFScheduler(EWSJFConfig(min_history=8))
    s2.load_state_dict(sched_state)
    assert s2.waiting() == 4


# layouts: one period (llama2), a 6-slot period (gemma3), MoE (phi3.5), a
# dense head block and shared experts (deepseek), a tail (recurrentgemma),
# no embedding table (hubert), SSM blocks without an MLP (mamba2), MLA
# with dense MLPs (minicpm3)
LAYOUT_ARCHS = ["llama2-13b", "gemma3-4b", "phi3.5-moe-42b-a6.6b",
                "deepseek-v2-lite-16b", "recurrentgemma-9b", "hubert-xlarge",
                "mamba2-370m", "minicpm3-4b"]


def _bridged_state(arch):
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    jst = jax_adamw_init(jp)
    rng = np.random.default_rng(0)     # moments that differ leaf by leaf
    jst = jst._replace(step=jnp.int32(3),
                       m=jax.tree.map(lambda t: jnp.asarray(
                           rng.standard_normal(t.shape), jnp.float32), jst.m))
    np_p, np_st = jax.tree.map(np.asarray, (jp, jst))
    tp = bridge.params_from_jax(np_p, tcfg, device="cpu")
    tst = bridge.opt_state_from_jax(np_st, tcfg, device="cpu")
    return tcfg, (jp, jst), (tp, tst)


@pytest.mark.parametrize("arch", LAYOUT_ARCHS)
def test_manifest_lists_the_leaves_of_a_jax_checkpoint(tmp_path, arch):
    """Same leaf count, shapes, dtypes and bytes as the JAX package's
    checkpoint of the same bridged state; the JAX checkpoint restores into
    the port bitwise; the optimizer-state bridge round-trips."""
    tcfg, (jp, jst), (tp, tst) = _bridged_state(arch)
    jd = jax_save(tmp_path / "jax", 3, (jp, jst))
    td = save_checkpoint(tmp_path / "port", 3,
                         bridge.train_state_tree(tp, tst, tcfg))
    jm, tm = (json.loads((d / "manifest.json").read_text()) for d in (jd, td))
    assert tm["n_leaves"] == jm["n_leaves"]
    assert [(x["shape"], x["dtype"]) for x in tm["leaves"]] == \
        [(x["shape"], x["dtype"]) for x in jm["leaves"]]
    for i in range(jm["n_leaves"]):
        np.testing.assert_array_equal(np.load(td / f"arr_{i:05d}.npy"),
                                      np.load(jd / f"arr_{i:05d}.npy"))

    fresh, fst = init_train_state(tcfg, torch.Generator().manual_seed(5),
                                  device="cpu")
    _, step, _ = restore_checkpoint(tmp_path / "jax",
                                    bridge.train_state_tree(fresh, fst, tcfg))
    assert step == 3 and int(fst.step) == 3
    for a, b in zip(fresh.parameters(), tp.parameters()):
        assert torch.equal(a, b)
    back = bridge.opt_state_to_numpy(fst, tcfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jst)):
        np.testing.assert_array_equal(a, np.asarray(b))


def _crash_and_restart(tmp_path, arch):
    """``launch/train.py`` on the CPU: 6 steps straight (checkpoints at 3
    and 6) against a run stopped at step 3 and resumed to 6 from its
    checkpoint, the data stream fast-forwarded.  Warmup is 10 steps, so the
    two runs' schedules agree; the final states are bitwise equal."""
    common = ["--arch", arch, "--batch", "2", "--seq", "32",
              "--ckpt-every", "3", "--device", "cpu"]
    straight = train_main(common + ["--steps", "6", "--ckpt-dir",
                                    str(tmp_path / "a")])
    train_main(common + ["--steps", "3", "--ckpt-dir", str(tmp_path / "b")])
    resumed = train_main(common + ["--steps", "6", "--resume",
                                   "--ckpt-dir", str(tmp_path / "b")])
    assert resumed["start"] == 3 and len(resumed["losses"]) == 3
    assert resumed["losses"] == straight["losses"][3:]
    for a, b in zip(straight["params"].parameters(),
                    resumed["params"].parameters()):
        assert torch.equal(a, b)
    so, ro = straight["opt_state"], resumed["opt_state"]
    assert int(so.step) == int(ro.step) == 6
    for k in so.m:
        assert torch.equal(so.m[k], ro.m[k]) and torch.equal(so.v[k], ro.v[k])
    assert latest_step(tmp_path / "a") == latest_step(tmp_path / "b") == 6
    return straight


def test_launcher_crash_and_restart_equals_straight_run(tmp_path):
    _crash_and_restart(tmp_path, "llama2-13b")


def test_launcher_crash_and_restart_trains_the_ssm_family(tmp_path):
    """The launcher trains mamba2's smoke config (SSM blocks through
    ``ssd_chunked``, which the launcher refused before training reached
    the SSM family); crash-and-restart as above."""
    straight = _crash_and_restart(tmp_path, "mamba2-370m")
    assert straight["cfg"].name == "mamba2-370m-smoke"
    assert all(np.isfinite(straight["losses"]))
