"""The port's training attention against the JAX package on the CPU:
``models/blockwise.py`` (``blockwise_gqa_attend``, ``reference_attend``) and
the dense ``attention.gqa_attend``, forward and backward.

The same numpy inputs (seeded) go through both packages in f32; the
gradients are ``jax.vjp`` against ``torch.autograd.grad`` with one random
cotangent.  Outputs must agree within 2e-5 of their scale and gradients
within 1e-4 of theirs: CPU matmuls in the two frameworks sum in different
orders.  Sequences of 2304 and 4096 cross the blockwise threshold (2048)
with the default blocks (512 queries, 1024 keys) at small widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import gqa_attend as jax_gqa_attend
from repro.models.blockwise import blockwise_gqa_attend as jax_blockwise
from repro.models.blockwise import reference_attend as jax_reference
from repro.models.common import attention_mask as jax_mask
from repro_torch.models.attention import BLOCKWISE_THRESHOLD, gqa_attend
from repro_torch.models.blockwise import blockwise_gqa_attend, reference_attend
from repro_torch.models.common import attention_mask

OUT_TOL, GRAD_TOL = 2e-5, 1e-4
HD, K = 16, 2


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


def _inputs(S, G, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, S, K * G, HD)).astype(np.float32)
    k = rng.standard_normal((1, S, K, HD)).astype(np.float32)
    v = rng.standard_normal((1, S, K, HD)).astype(np.float32)
    ct = rng.standard_normal((1, S, K * G * HD)).astype(np.float32)
    return q, k, v, ct


def _jax_out_grads(fn, q, k, v, ct):
    @jax.jit
    def run(q, k, v, ct):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out, *vjp(ct))
    return [np.asarray(t) for t in run(*map(jnp.asarray, (q, k, v, ct)))]


def _torch_out_grads(fn, q, k, v, ct):
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(ct))
    return [out.detach().numpy()] + [g.numpy() for g in grads]


def _close(got, want, tol, what):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err:.3g} > {tol} x {scale:.3g}"


def _check(got, want, label):
    _close(got[0], want[0], OUT_TOL, f"{label} output")
    for name, g, w in zip("qkv", got[1:], want[1:]):
        _close(g, w, GRAD_TOL, f"{label} d{name}")


# (S, G, causal, window, q_offset): causal, windowed causal (local / SWA
# layers, a banded KV span) and bidirectional (the encoder), at both
# lengths, each group size and with and without a query offset
CASES = [(2304, 1, True, 0, 0), (2304, 1, True, 256, 0),
         (2304, 1, False, 0, 0), (2304, 2, True, 0, 128),
         (2304, 2, True, 256, 128), (2304, 2, False, 0, 128),
         (4096, 2, True, 0, 0), (4096, 2, True, 256, 0),
         (4096, 2, False, 0, 0), (4096, 1, True, 256, 128)]
MODES = [(True, 0, 0), (True, 256, 128), (False, 0, 128)]


@pytest.mark.parametrize("S,G,causal,window,q_offset", CASES)
def test_blockwise_matches_jax(S, G, causal, window, q_offset):
    q, k, v, ct = _inputs(S, G, seed=S + G + window + q_offset)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = _jax_out_grads(lambda *a: jax_blockwise(*a, **kw), q, k, v, ct)
    got = _torch_out_grads(lambda *a: blockwise_gqa_attend(*a, **kw),
                           q, k, v, ct)
    _check(got, want, "blockwise")
    # and the port's blockwise against its own dense oracle
    _check(got, _torch_out_grads(lambda *a: reference_attend(*a, **kw),
                                 q, k, v, ct), "blockwise vs reference")


@pytest.mark.parametrize("causal,window,q_offset", MODES)
def test_reference_attend_matches_jax(causal, window, q_offset):
    q, k, v, ct = _inputs(2304, 2, seed=7)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    _check(_torch_out_grads(lambda *a: reference_attend(*a, **kw), q, k, v, ct),
           _jax_out_grads(lambda *a: jax_reference(*a, **kw), q, k, v, ct),
           "reference")


def test_rows_with_no_visible_key_give_zero():
    """Queries whose window holds no key see nothing: their rows are 0 in
    both packages' blockwise attention."""
    S = 2304
    q, k, v, ct = _inputs(S, 2, seed=3)
    kw = dict(causal=True, window=256, q_offset=S)
    got = _torch_out_grads(lambda *a: blockwise_gqa_attend(*a, **kw),
                           q, k, v, ct)
    want = _jax_out_grads(lambda *a: jax_blockwise(*a, **kw), q, k, v, ct)
    _check(got, want, "blockwise, no visible key")
    assert not got[0][0, 255:].any()   # query S + i sees no key from i = 255


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16), (False, 0)])
def test_dense_gqa_attend_matches_jax(causal, window):
    """The training attention at or below the threshold."""
    S = 64
    assert S <= BLOCKWISE_THRESHOLD
    q, k, v, ct = _inputs(S, 2, seed=11)
    want = _jax_out_grads(
        lambda *a: jax_gqa_attend(*a, jax_mask(S, S, causal=causal,
                                               window=window)), q, k, v, ct)
    got = _torch_out_grads(
        lambda *a: gqa_attend(*a, attention_mask(S, S, causal=causal,
                                                 window=window)), q, k, v, ct)
    _check(got, want, "gqa_attend")
