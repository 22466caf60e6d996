"""The port's training path on the CPU against the JAX package: the RMSNorm
backward, the chunked cross-entropy, ``train_loss`` and its gradients, the
AdamW train step, and the ports of ``tests/test_training.py``.

Weights come from the JAX initializer and cross through ``bridge``; inputs
are numpy arrays drawn from a seed (``TokenDataset`` for the train steps).
In f32 compute the loss must agree within 1e-5 relative and each gradient
leaf within 1e-4 of that leaf's largest |g|: CPU matmuls in the two
frameworks sum in different orders.  Under ``DtypePolicy.train()`` (bf16
compute) the two packages round at different points (XLA on the CPU keeps
fused element-wise chains in f32, PyTorch rounds each op to bf16): the
port's loss is held within ``BF16_LOSS`` relative and, for the dense
families, each gradient leaf within ``BF16_GRAD`` of its scale.  Measured
on these inputs: losses 1.8e-5 to 1.4e-4 relative, gradients 1.3e-2 to
3.5e-2 of scale (up to 5.1e-2 on another batch); the JAX package's own
jitted and op-by-op runs of the same bf16 loss differ by 2.3e-2 (llama2)
and 3.3e-2 (qwen3) of scale.  Under
bf16 the MoE router's top-k may part at near-ties, which moves whole
expert rows of the gradient and the loss by about 1e-3 (measured 3.8e-4
and 8.4e-4 relative on two batches), so phi3.5's bf16 case holds the loss
within ``BF16_MOE_LOSS`` and the global gradient norm within 1e-2
relative (measured 7.3e-4); its f32 case holds every leaf.  deepseek's
bf16 case is held the same way.  recurrentgemma's bf16 gradients are
noisier: the RG-LRU recurrence carries each rounding through the
sequence, so that JAX's own bf16 gradients lie 0.076 to 0.140 of a leaf's
scale from its f32 gradients on the four batches of its bf16 cases.
Those cases measure both packages against JAX's f32 gradients, the true
ones, and print what they measure (``pytest -s``): the port's global
gradient error (the norm of the difference over the norm of the f32
gradient) may be at most ``BF16_RGLRU_RATIO`` times JAX's bf16 one
(measured 0.95 to 1.01 times, 0.038 to 0.044), each of its leaves lies
within ``BF16_RGLRU_GRAD`` of the f32 leaf's scale (the port 0.067 to
0.120), and, as for MoE, its loss is within ``BF16_LOSS`` and its
gradient norm within 1e-2 of JAX's bf16 ones (measured 1.0e-5 to 1.1e-4
and 2.9e-4 to 1.2e-3).

The SSM, RG-LRU and MLA families (mamba2, recurrentgemma, deepseek,
minicpm3) train through torch ops only: ``test_training_reaches_no_kernel_
wrapper`` runs their loss and gradients with every kernel wrapper
replaced by one that raises.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import init_params as jax_init
from repro.models.common import DtypePolicy as JaxPolicy
from repro.models.common import rms_norm as jax_rms_norm
from repro.models.model import chunked_cross_entropy as jax_ce
from repro.models.model import train_loss as jax_train_loss
from repro.models.transformer import MoECtx
from repro.training import AdamWConfig as JaxAdamWConfig
from repro.training import DataConfig as JaxDataConfig
from repro.training import TokenDataset as JaxTokenDataset
from repro.training import adamw_init as jax_adamw_init
from repro.training import adamw_update as jax_adamw_update
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.models import DtypePolicy, init_params, train_loss
from repro_torch.models.common import rms_norm
from repro_torch.models.model import chunked_cross_entropy
from repro_torch.training import (AdamWConfig, DataConfig, TokenDataset,
                                  adamw_init, adamw_update, batch_to,
                                  cosine_lr, init_train_state,
                                  make_train_step)

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
BF16_LOSS, BF16_GRAD = 5e-4, 6e-2
BF16_MOE_LOSS = 2e-3        # a parted top-k moves the loss by ~1e-3
BF16_RGLRU_GRAD = 0.15      # of the f32 leaf; JAX's bf16: 0.076-0.140
BF16_RGLRU_RATIO = 1.25     # the port's global bf16 error over JAX's
J32 = JaxPolicy(jnp.float32, jnp.float32, jnp.float32)
T32 = DtypePolicy(torch.float32, torch.float32, torch.float32)


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


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------

def _rms_norm_before(x, scale, eps):
    """The port's forward-only RMSNorm as it was before its VJP."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return (xf * inv * (1.0 + scale.float())).to(x.dtype)


@pytest.mark.parametrize("xdt,sdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)])
def test_rms_norm_forward_is_bitwise_unchanged(xdt, sdt):
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(3, 7, 96, generator=g) * 3).to(xdt)
    s = torch.randn(96, generator=g).to(sdt)
    assert torch.equal(rms_norm(x, s, 1e-6), _rms_norm_before(x, s, 1e-6))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_vjp_matches_jax(dtype):
    """f32: within 1e-6 of scale; bf16 x (f32 scale, as in training): dx
    within one bf16 ulp of JAX's, dscale (f32) within 1e-6 of scale."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 5, 64)) * 2).astype(np.float32)
    s = rng.standard_normal(64).astype(np.float32) * 0.1
    g = rng.standard_normal((2, 5, 64)).astype(np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jx, jg = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    _, vjp = jax.vjp(lambda a, b: jax_rms_norm(a, b, 1e-6), jx, jnp.asarray(s))
    jdx, jds = (np.asarray(t.astype(jnp.float32)) for t in vjp(jg))
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    ts = torch.from_numpy(s).requires_grad_(True)
    dx, ds = torch.autograd.grad(rms_norm(tx, ts, 1e-6), (tx, ts),
                                 torch.from_numpy(g).to(tdt))
    assert dx.dtype == tdt and ds.dtype == torch.float32
    dx, ds = dx.float().numpy(), ds.numpy()
    assert np.abs(ds - jds).max() <= 1e-6 * np.abs(jds).max()
    if dtype == "f32":
        assert np.abs(dx - jdx).max() <= 1e-6 * np.abs(jdx).max()
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(jdx), 1e-30))) - 7)
        assert np.all(np.abs(dx - jdx) <= ulp)


def test_rms_norm_gradcheck_f64():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 3, 8, generator=g, dtype=torch.float64,
                    requires_grad=True)
    s = torch.randn(8, generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, b: rms_norm(a, b, 1e-6), (x, s))


# --------------------------------------------------------------------------
# cross-entropy
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S,softcap", [(64, 0.0), (64, 30.0), (48, 0.0)])
def test_chunked_cross_entropy_matches_jax(S, softcap):
    """Chunks of 32: S 48 halves the chunk to 16.  Value and the gradient
    in the hidden states, f32."""
    rng = np.random.default_rng(S)
    h = rng.standard_normal((2, S, 16)).astype(np.float32)
    w = rng.standard_normal((16, 50)).astype(np.float32)
    y = rng.integers(0, 50, (2, S)).astype(np.int32)
    jl, jdh = jax.value_and_grad(lambda a: jax_ce(
        a, jnp.asarray(w), jnp.asarray(y), chunk=32, softcap=softcap))(
            jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_(True)
    tl = chunked_cross_entropy(th, torch.from_numpy(w), torch.from_numpy(y),
                               chunk=32, softcap=softcap)
    (tdh,) = torch.autograd.grad(tl, th)
    assert abs(float(tl.detach()) - float(jl)) <= LOSS_TOL * abs(float(jl))
    jdh = np.asarray(jdh)
    assert np.abs(tdh.numpy() - jdh).max() <= GRAD_TOL * np.abs(jdh).max()


# --------------------------------------------------------------------------
# train_loss and its gradients
# --------------------------------------------------------------------------

def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.input_mode == "embeddings":
        out["embeddings"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size,
                                     (B, S)).astype(np.int32)
    return out


def _port_loss_grads(tp, batch, cfg, policy, remat=True):
    named = dict(tp.named_parameters())
    loss = train_loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                      cfg, policy=policy, remat=remat)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return float(loss.detach()), bridge.named_to_numpy(
        {k: torch.zeros_like(p) if g is None else g
         for (k, p), g in zip(named.items(), grads)}, cfg)


# (arch, B, S): dense GQA, qk_norm, windowed local layers, MoE under
# `dropping` (aux loss; router cast to the compute dtype), a bidirectional
# encoder fed embeddings, the SSM family (S 64: two chunks of 32), the
# RG-LRU hybrid, MLA with MoE and a dense head layer, MLA with dense MLPs;
# and past the blockwise threshold llama2, deepseek (MLA folded into MHA
# form, scale (hd + rd)^-0.5) and recurrentgemma (windowed local layers);
# and recurrentgemma's noisier bf16 gradients on three more batches
LOSS_CASES = ([(arch, 2, 64 if arch == "mamba2-370m" else 32, compute)
               for arch in ("llama2-13b", "qwen3-4b", "gemma3-4b",
                            "phi3.5-moe-42b-a6.6b", "hubert-xlarge",
                            "mamba2-370m", "recurrentgemma-9b",
                            "deepseek-v2-lite-16b", "minicpm3-4b")
               for compute in ("f32", "bf16")]
              + [(arch, 1, 2304, "f32")
                 for arch in ("llama2-13b", "deepseek-v2-lite-16b",
                              "recurrentgemma-9b")]
              + [("recurrentgemma-9b", 2, S, "bf16") for S in (24, 40, 48)])


def _jax_loss_grads(jp, batch, jcfg, policy):
    """JAX's loss and gradient leaves (as f32 numpy) on ``batch``."""
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jax_train_loss(p, b, jcfg, MoECtx(impl="dropping"),
                                    policy=policy, remat=True)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(jl), [np.asarray(a, np.float32)
                       for a in jax.tree.leaves(jg)]


def _worst_leaf(ref, leaves):
    """The largest |difference| of any leaf over that ``ref`` leaf's
    largest |value|."""
    return max(float(np.abs(a - b).max()) / max(float(np.abs(a).max()),
                                                 1e-30)
               for a, b in zip(ref, leaves))


def _global_norm(leaves):
    return np.sqrt(sum(float((np.asarray(a, np.float64) ** 2).sum())
                       for a in leaves))


@pytest.mark.parametrize("arch,B,S,compute", LOSS_CASES)
def test_train_loss_and_grads_match_jax(arch, B, S, compute):
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu").requires_grad_(True)
    batch = _batch(jcfg, B, S, seed=S)
    jpol, tpol = ((J32, T32) if compute == "f32"
                  else (JaxPolicy.train(), DtypePolicy.train()))
    jl, jleaves = _jax_loss_grads(jp, batch, jcfg, jpol)
    tl, tg = _port_loss_grads(tp, batch, tcfg, tpol)
    tleaves = jax.tree.leaves(tg)
    assert len(jleaves) == len(tleaves)
    loss_tol, grad_tol = ((LOSS_TOL, GRAD_TOL) if compute == "f32"
                          else (BF16_LOSS, BF16_GRAD))
    if compute == "bf16" and jcfg.n_experts:
        loss_tol = BF16_MOE_LOSS
    assert abs(tl - jl) <= loss_tol * abs(jl), (tl, jl)
    if compute == "bf16" and (jcfg.n_experts or "rglru" in jcfg.pattern):
        jn, tn = _global_norm(jleaves), _global_norm(tleaves)
        assert abs(tn - jn) <= 1e-2 * jn, (tn, jn)
    if compute == "bf16" and jcfg.n_experts:
        return
    if compute == "bf16" and "rglru" in jcfg.pattern:
        _, j32 = _jax_loss_grads(jp, batch, jcfg, J32)
        n32 = _global_norm(j32)
        j_err = _global_norm([a - b for a, b in zip(j32, jleaves)]) / n32
        t_err = _global_norm([a - b for a, b in zip(j32, tleaves)]) / n32
        print(json.dumps({"arch": arch, "B": B, "S": S,
                          "global_err_jax": j_err, "global_err_port": t_err,
                          "leaf_err_jax": _worst_leaf(j32, jleaves),
                          "leaf_err_port": _worst_leaf(j32, tleaves),
                          "loss_rel": abs(tl - jl) / abs(jl),
                          "norm_rel": abs(tn - jn) / jn}))
        assert t_err <= BF16_RGLRU_RATIO * j_err, (t_err, j_err)
        jleaves, grad_tol = j32, BF16_RGLRU_GRAD
    for i, (a, b) in enumerate(zip(jleaves, tleaves)):
        assert a.shape == b.shape
        scale = max(np.abs(a).max(), 1e-30)
        assert np.abs(a - b).max() <= grad_tol * scale, (i, a.shape)


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b",
                                  "deepseek-v2-lite-16b", "minicpm3-4b"])
def test_training_reaches_no_kernel_wrapper(arch, monkeypatch):
    """The loss and its gradients with every kernel wrapper the models
    import replaced by one that raises: the training forward reaches none
    (the prefill wrappers would refuse autograd anyway)."""
    from repro_torch.models import attention, ssm

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called in training")

    for mod, name in ((attention, "flash_attention"),
                      (attention, "paged_attention"), (ssm, "ssd")):
        monkeypatch.setattr(mod, name, refuse)
    cfg = get_smoke_config(arch)
    tp = init_params(cfg, torch.Generator().manual_seed(0),
                     device="cpu").requires_grad_(True)
    loss, grads = _port_loss_grads(tp, _batch(cfg, 2, 48, seed=7), cfg, T32)
    assert np.isfinite(loss)
    assert all(np.isfinite(g).all() for g in jax.tree.leaves(grads))


@pytest.mark.parametrize("arch", ["mamba2-370m", "deepseek-v2-lite-16b"])
def test_prefill_forward_refuses_autograd(arch):
    """The prefill mixers (``ssm_forward`` through ``ops.ssd``,
    ``mla_forward`` through the flash wrapper) with weights that require
    grad raise the wrappers' ``RuntimeError`` on the CPU too; with
    ``train=True`` the same call runs."""
    from repro_torch.models.attention import mla_forward
    from repro_torch.models.ssm import ssm_forward
    cfg = get_smoke_config(arch)
    tp = init_params(cfg, torch.Generator().manual_seed(0),
                     device="cpu").requires_grad_(True)
    bp = tp.blocks[0]
    mixer = dict(bp.mixer)
    x = torch.randn((1, 40, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    if bp.kind == "ssm":
        def run(train):
            return ssm_forward(mixer, x, cfg, train=train)
    else:
        pos = torch.arange(40)[None]

        def run(train):
            return mla_forward(mixer, x, cfg, positions=pos, train=train)
    with pytest.raises(RuntimeError, match="no backward"):
        run(False)
    assert run(True).requires_grad


@pytest.mark.parametrize("arch", ["gemma3-4b", "phi3.5-moe-42b-a6.6b",
                                  "mamba2-370m", "recurrentgemma-9b"])
def test_remat_gradients_bitwise_equal(arch):
    """Checkpointing each period (and the head and tail segments, and the
    RG-LRU scan, which is checkpointed either way) recomputes the same f32
    numbers."""
    cfg = get_smoke_config(arch)
    tp = init_params(cfg, torch.Generator().manual_seed(0),
                     device="cpu").requires_grad_(True)
    batch = _batch(cfg, 2, 32, seed=5)
    la, ga = _port_loss_grads(tp, batch, cfg, T32, remat=True)
    lb, gb = _port_loss_grads(tp, batch, cfg, T32, remat=False)
    assert la == lb
    for a, b in zip(jax.tree.leaves(ga), jax.tree.leaves(gb)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

def test_five_train_steps_match_jax():
    """Five AdamW steps from bridged weights and optimizer state on the
    same TokenDataset batches, f32 compute: the losses agree within 1e-4
    relative.  (Parameters are not compared: Adam turns float residues on
    rows no batch touches into lr-sized steps.)"""
    arch = "llama2-13b"
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    jopt = JaxAdamWConfig(lr_peak=3e-3, warmup_steps=2, total_steps=10)
    topt = AdamWConfig(lr_peak=3e-3, warmup_steps=2, total_steps=10)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    jst = jax_adamw_init(jp)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu").requires_grad_(True)
    tst = bridge.opt_state_from_jax(jax.tree.map(np.asarray, jst), tcfg,
                                    device="cpu")

    @jax.jit
    def jax_step(p, st, b):
        loss, g = jax.value_and_grad(lambda q: jax_train_loss(
            q, b, jcfg, MoECtx(), policy=J32, remat=True))(p)
        p, st, m = jax_adamw_update(g, st, p, jopt)
        return p, st, loss, m["grad_norm"]

    step = make_train_step(tcfg, topt, policy=T32)
    jit_ = JaxTokenDataset(jcfg, JaxDataConfig(global_batch=2,
                                               seq_len=32)).batches()
    tit = TokenDataset(tcfg, DataConfig(global_batch=2, seq_len=32)).batches()
    for _ in range(5):
        jb, tb = next(jit_), next(tit)
        assert all(np.array_equal(jb[k], tb[k]) for k in jb)
        jp, jst, jl, jn = jax_step(jp, jst, {k: jnp.asarray(v)
                                             for k, v in jb.items()})
        tp, tst, m = step(tp, tst, batch_to(tb, "cpu"))
        assert abs(float(m["loss"]) - float(jl)) <= 1e-4 * abs(float(jl))
        assert abs(float(m["grad_norm"]) - float(jn)) <= 1e-4 * float(jn)
    assert int(tst.step) == int(jst.step) == 5


def test_loss_decreases_on_planted_structure():
    cfg = get_smoke_config("llama2-13b")
    step_fn = make_train_step(
        cfg, AdamWConfig(lr_peak=3e-3, warmup_steps=5, total_steps=40),
        remat=True)
    params, opt = init_train_state(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    it = TokenDataset(cfg, DataConfig(global_batch=4, seq_len=64)).batches()
    losses = []
    for _ in range(40):
        params, opt, m = step_fn(params, opt, batch_to(next(it), "cpu"))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3


def test_microbatch_equivalence():
    """Mean loss and mean gradient match between 1 and 2 microbatches, bf16
    compute (the JAX test's tolerances), and the train step's two-
    microbatch path sums and divides the same way."""
    cfg = get_smoke_config("qwen3-4b")
    params, st = init_train_state(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    it = TokenDataset(cfg, DataConfig(global_batch=4, seq_len=32)).batches()
    b = next(it)

    def loss_grads(batch):
        named = dict(params.named_parameters())
        loss = train_loss(params, batch_to(batch, "cpu"), cfg, remat=False)
        return (float(loss.detach()),
                torch.autograd.grad(loss, list(named.values())))

    l1, g1 = loss_grads(b)
    l2a, g2a = loss_grads({k: v[:2] for k, v in b.items()})
    l2b, g2b = loss_grads({k: v[2:] for k, v in b.items()})
    assert abs(l1 - 0.5 * (l2a + l2b)) < 5e-4
    for a, ba, bb in zip(g1, g2a, g2b):
        np.testing.assert_allclose(a.numpy(), 0.5 * (ba + bb).numpy(),
                                   atol=3e-4, rtol=1e-2)
    opt = AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=4)
    _, _, m = make_train_step(cfg, opt, num_microbatches=2, remat=False)(
        params, st, batch_to(b, "cpu"))
    assert abs(float(m["loss"]) - 0.5 * (l2a + l2b)) < 1e-6


def test_cosine_schedule_shape():
    cfg = AdamWConfig(lr_peak=1.0, warmup_steps=10, total_steps=100)
    lrs = [cosine_lr(cfg, s) for s in (0, 5, 10, 55, 100)]
    assert lrs[0] == 0.0
    assert abs(lrs[2] - 1.0) < 1e-6
    assert lrs[3] < 1.0 and lrs[4] < 1e-6


def test_grad_clip_bounds_update():
    params = {"w": torch.zeros((4,))}
    grads = {"w": torch.full((4,), 1e6)}
    state = adamw_init(params)
    cfg = AdamWConfig(lr_peak=1.0, warmup_steps=1, total_steps=2,
                      clip_norm=1.0, weight_decay=0.0)
    new, state, m = adamw_update(grads, state, params, cfg)
    assert float(m["grad_norm"]) > 1e5
    assert np.all(np.abs(new["w"].numpy()) < 10.0)


# --------------------------------------------------------------------------
# the model-FLOPs count (launch/op_count.py, which chip_smoke.py imports)
# --------------------------------------------------------------------------

def _chip_smoke():
    from repro_torch.launch import op_count
    return op_count


def _meta_params(arch):
    """The card run's config and its weights on the meta device (shapes
    only, nothing allocated)."""
    from repro_torch.launch.serve import TRAIN_DEPTH_CUTS, card_config
    cfg = card_config(arch, TRAIN_DEPTH_CUTS)
    return cfg, init_params(cfg, torch.Generator(), device="meta")


def test_train_flops_keeps_llama2_figures():
    """Counted from the parameters, llama2-13b's cut at 2 x 4096 gives its
    closed form exactly: model, executed FLOPs and N."""
    smoke = _chip_smoke()
    cfg, params = _meta_params("llama2-13b")
    got = smoke.train_flops(params, cfg, 2, 4096)
    assert got == smoke.llama2_train_flops(cfg, 2, 4096)
    assert got[2] == sum(p.numel() for p in params.parameters()
                         if p.dim() >= 2) - cfg.vocab_size * cfg.d_model


def test_train_flops_counts_active_experts_and_mla():
    """deepseek's cut (a dense head layer, 4 MoE layers): N by hand from
    the config (routed experts at top-6 of 64, router and 2 shared experts
    whole, MLA's projections, the untied head), and the attention products
    at dk = hd + rd, dv = vd over the whole span."""
    smoke = _chip_smoke()
    cfg, params = _meta_params("deepseek-v2-lite-16b")
    d, H, hd, rd = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    r, vd = cfg.kv_lora_rank, cfg.v_head_dim
    E, k = cfg.n_experts, cfg.moe_top_k
    mla = d * H * (hd + rd) + d * r + d * rd + r * H * hd + r * H * vd \
        + H * vd * d
    moe = 3 * d * cfg.moe_d_ff * k + d * E \
        + 3 * d * cfg.moe_d_ff * cfg.n_shared_experts
    n = 5 * mla + 3 * d * cfg.d_ff + 4 * moe + d * cfg.vocab_size
    B, S = 2, 4096
    model, _, got_n = smoke.train_flops(params, cfg, B, S)
    assert got_n == n
    assert model == 6 * n * B * S + 3 * 5 * B * S * S * 2 * H * (hd + rd + vd)


def test_train_flops_counts_the_ssd_products_a_group():
    """mamba2-370m whole (no attention, untied head): N by hand (the input
    and output projections and the depthwise conv of every layer, the
    head), the SSD's products a layer and a token, 2·(Q·N·G + Q·H·P +
    2·H·P·N), three times in the model count and four times as executed,
    the scores a group as ``ssd_chunk_train`` takes them."""
    smoke = _chip_smoke()
    cfg, params = _meta_params("mamba2-370m")
    d, di, L = cfg.d_model, cfg.d_inner, cfg.n_layers
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads
    P, Q = cfg.ssm_head_dim, cfg.ssm_chunk
    conv = di + 2 * G * N
    n = L * (d * (2 * di + 2 * G * N + H) + cfg.conv_width * conv + di * d) \
        + d * cfg.vocab_size
    B, S = 8, 4096
    ssd = L * 2 * B * S * (Q * N * G + Q * H * P + 2 * H * P * N)
    # executed: the recompute leaves out the head and each layer's out_proj
    # (the checkpoint's early stop; launch/op_count.py::train_flops)
    recomputed = n - d * cfg.vocab_size - L * di * d
    assert smoke.train_flops(params, cfg, B, S) == (
        6 * n * B * S + 3 * ssd, 6 * n * B * S + 2 * recomputed * B * S
        + 4 * ssd, n)


def test_profile_train_runs_a_smoke_step_on_the_cpu():
    """``launch/profile_train.py``'s step on a smoke config on the CPU,
    where no device time is recorded."""
    from repro_torch.launch.profile_train import profile_step
    out = profile_step(get_smoke_config("mamba2-370m"), 2, 48,
                       torch.device("cpu"))
    assert out["layers"] == 4 and out["step_ms"] > 0
    assert out["device_ms_by_class"] == {} and out["device_busy_ms"] == 0
