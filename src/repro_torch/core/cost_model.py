"""Analytic roofline cost model for scheduling and simulation (H100 peaks).

Two roles:

1. ``C_prefill(b)`` — the paper's estimated prefill cost (denominator of the
   compute-score ``cs = W_t / C_prefill(b)``, Eq. 1).  The paper measures this
   on A100s; here it is derived from a roofline over the card's peak rates:
   cost = max(compute_term, memory_term) per request of prompt length b.

2. Step-time estimation for the discrete-event simulator that reproduces the
   paper's tables (benchmarks/).  The simulator charges each engine step
   max(compute, memory) seconds given the batch composition.

Per-family cost exponents: attention prefill is quadratic in b for
full-attention transformers, linear for SSM/linear-recurrent families and
windowed attention — exposed so EWSJF's scoring stays faithful across the
assigned architecture families (DESIGN.md §4).
"""

from __future__ import annotations

from dataclasses import dataclass, field

# NVIDIA H100 SXM data-sheet peaks (dense bf16 tensor-core rate, HBM3
# bandwidth).  They are the CostModel defaults, not measurements.
H100_PEAK_FLOPS_BF16 = 989e12   # FLOP/s per card
H100_HBM_BW = 3.35e12           # bytes/s per card
# NVLink 4 between two H100 SXM cards: the data sheet's 900 GB/s is the
# sum of both directions, so one direction carries 450 GB/s.  The default
# link rate for KV handoffs and remote prefix fetches.
H100_NVLINK_BW = 450e9          # bytes/s per direction


@dataclass(frozen=True)
class ModelCostParams:
    """Minimal description of a served model for cost purposes."""

    n_params_active: float       # active params per token (MoE: top-k slice)
    n_layers: int
    d_model: int
    n_kv_heads: int
    head_dim: int
    attn_kind: str = "full"      # full | window | linear (ssm / rg-lru)
    window: int = 4096           # effective window for attn_kind == "window"
    dtype_bytes: int = 2

    @property
    def kv_bytes_per_token(self) -> float:
        """KV-cache bytes one token occupies across all layers."""
        return (2 * self.n_layers * self.n_kv_heads * self.head_dim
                * self.dtype_bytes)


# Default model for scheduling cost estimates: the paper's LLaMA-2-13B.
LLAMA2_13B_COST = ModelCostParams(
    n_params_active=13e9, n_layers=40, d_model=5120,
    n_kv_heads=40, head_dim=128, attn_kind="full",
)


@dataclass
class CostModel:
    """Roofline cost model over one chip-group (``n_chips`` tensor-parallel).

    ``peak_flops`` (FLOP/s) and ``hbm_bw`` (bytes/s) are per-chip peaks
    and ``link_bw`` (bytes/s) the rate of one directed link between two
    replicas; the defaults are one H100 SXM's data-sheet figures.  Pass
    other values to model another part (the parity tests pass the JAX
    package's constants to reproduce its decisions)."""

    model: ModelCostParams = LLAMA2_13B_COST
    n_chips: int = 1
    peak_flops: float = H100_PEAK_FLOPS_BF16
    hbm_bw: float = H100_HBM_BW
    link_bw: float = H100_NVLINK_BW
    mfu: float = 0.5             # achievable fraction of peak on prefill
    hbm_eff: float = 0.8

    # ---- request-level costs (used by EWSJF scoring) -------------------

    def attn_ctx(self, b: float) -> float:
        """Effective attention context per token at prompt length b."""
        kind = self.model.attn_kind
        if kind == "linear":
            return 0.0           # state-space: no KV attention term
        if kind == "window":
            return min(b, self.model.window) / 2.0
        return b / 2.0           # causal full attention: avg context b/2

    def prefill_flops(self, b: float) -> float:
        """FLOPs to prefill one prompt of length ``b``."""
        m = self.model
        dense = 2.0 * m.n_params_active * b
        attn = (4.0 * m.n_layers * m.d_model * b * self.attn_ctx(b))
        return dense + attn

    def prefill_bytes(self, b: float) -> float:
        """Bytes moved to prefill one prompt of length ``b``."""
        m = self.model
        weights = m.n_params_active * m.dtype_bytes   # streamed once per step
        kv = m.kv_bytes_per_token * b
        return weights + kv

    def c_prefill(self, b: float) -> float:
        """The paper's C_prefill(b): seconds to prefill one request of
        length b on this chip group (roofline max of compute & memory)."""
        comp = self.prefill_flops(b) / (self.n_chips * self.peak_flops * self.mfu)
        mem = self.prefill_bytes(b) / (self.n_chips * self.hbm_bw * self.hbm_eff)
        return max(comp, mem)

    def prefill_cost(self, b: float, cached: float = 0.0) -> float:
        """Effective-workload prefill cost (KV plane): seconds to prefill a
        length-``b`` prompt whose first ``cached`` tokens are already
        resident in the KV cache.  Only the uncached suffix ``s = b-cached``
        runs through the model (dense FLOPs scale with s; each suffix token
        still attends to the *full* context, so the attention term uses
        ``cached + s/2`` average context); on the memory side the cached
        prefix KV is read but not recomputed or rewritten.  ``cached=0``
        reduces exactly to :meth:`c_prefill`."""
        if cached <= 0.0:
            return self.c_prefill(b)
        s = max(b - cached, 1.0)
        cached = b - s
        m = self.model
        dense = 2.0 * m.n_params_active * s
        if m.attn_kind == "linear":
            ctx = 0.0
        elif m.attn_kind == "window":
            ctx = min(b, self.model.window) / 2.0
        else:
            ctx = cached + s / 2.0
        attn = 4.0 * m.n_layers * m.d_model * s * ctx
        comp = (dense + attn) / (self.n_chips * self.peak_flops * self.mfu)
        mem = (m.n_params_active * m.dtype_bytes
               + m.kv_bytes_per_token * b) / (
                   self.n_chips * self.hbm_bw * self.hbm_eff)
        return max(comp, mem)

    # ---- step-level costs (used by the simulator) ----------------------

    def prefill_step_time(self, batch_tokens: int, mean_ctx: float) -> float:
        """One prefill engine step over ``batch_tokens`` total padded tokens."""
        m = self.model
        dense = 2.0 * m.n_params_active * batch_tokens
        attn = 4.0 * m.n_layers * m.d_model * batch_tokens * min(
            mean_ctx / 2.0, self.attn_ctx(mean_ctx) + 1.0)
        comp = (dense + attn) / (self.n_chips * self.peak_flops * self.mfu)
        mem = (m.n_params_active * m.dtype_bytes
               + m.kv_bytes_per_token * batch_tokens) / (
                   self.n_chips * self.hbm_bw * self.hbm_eff)
        return max(comp, mem)

    def attach_copy_time(self, tokens: float) -> float:
        """Seconds to copy ``tokens`` of cached prefix KV into a slot's
        cache span (the engine-side radix attach).  Pure memory traffic:
        the block rows are read from the host store and written into the
        slot — no compute term."""
        return (2.0 * self.model.kv_bytes_per_token * tokens
                / (self.n_chips * self.hbm_bw * self.hbm_eff))

    def decode_step_time(self, batch_size: int, total_kv_tokens: int) -> float:
        """One decode step: generate 1 token for each of ``batch_size`` seqs
        holding ``total_kv_tokens`` of KV cache in aggregate.  Decode is
        memory-bound: weights + KV traffic dominate."""
        m = self.model
        comp = 2.0 * m.n_params_active * batch_size / (
            self.n_chips * self.peak_flops * self.mfu)
        kv_traffic = (0.0 if m.attn_kind == "linear"
                      else m.kv_bytes_per_token * min(
                          total_kv_tokens,
                          batch_size * self.model.window
                          if m.attn_kind == "window" else total_kv_tokens))
        mem = (m.n_params_active * m.dtype_bytes + kv_traffic) / (
            self.n_chips * self.hbm_bw * self.hbm_eff)
        return max(comp, mem)


@dataclass
class CalibratedCostModel(CostModel):
    """Roofline model with per-op-class affine corrections layered on top.

    ``correction`` is the plain-dict export of
    ``CostCalibrator.correction()`` of the JAX package's calibration plane:
    ``{op_class: {"scale": s, "offset": o, ...}}`` mapping a raw roofline
    prediction ``x`` seconds to ``max(s*x + o, 1e-12)``.  Op classes the
    calibrator never converged on pass through uncorrected, so a partial
    fit degrades gracefully to the analytic model.  The class keys are the
    calibration plane's taxonomy — ``prefill_chunk`` (all prefill-shaped
    work), ``decode_step``, ``attach_copy`` — kept as string literals here
    so core stays import-free of obs (obs is a leaf; core must not close a
    cycle through it).
    """

    correction: dict = field(default_factory=dict)

    def _apply(self, op_class: str, seconds: float) -> float:
        c = self.correction.get(op_class)
        if c is None:
            return seconds
        return max(c["scale"] * seconds + c["offset"], 1e-12)

    def c_prefill(self, b: float) -> float:
        """Corrected :meth:`CostModel.c_prefill`."""
        return self._apply("prefill_chunk", super().c_prefill(b))

    def prefill_cost(self, b: float, cached: float = 0.0) -> float:
        """Corrected :meth:`CostModel.prefill_cost`."""
        return self._apply("prefill_chunk", super().prefill_cost(b, cached))

    def prefill_step_time(self, batch_tokens: int, mean_ctx: float) -> float:
        """Corrected :meth:`CostModel.prefill_step_time`."""
        return self._apply("prefill_chunk",
                           super().prefill_step_time(batch_tokens, mean_ctx))

    def attach_copy_time(self, tokens: float) -> float:
        """Corrected :meth:`CostModel.attach_copy_time`."""
        return self._apply("attach_copy", super().attach_copy_time(tokens))

    def decode_step_time(self, batch_size: int,
                         total_kv_tokens: int) -> float:
        """Corrected :meth:`CostModel.decode_step_time`."""
        return self._apply("decode_step",
                           super().decode_step_time(batch_size,
                                                    total_kv_tokens))

    @classmethod
    def from_fit(cls, base: CostModel,
                 correction: dict) -> "CalibratedCostModel":
        """Wrap an existing analytic model with a calibrator's fitted
        correction (``CostCalibrator.correction()`` output)."""
        return cls(model=base.model, n_chips=base.n_chips,
                   peak_flops=base.peak_flops, hbm_bw=base.hbm_bw,
                   link_bw=base.link_bw,
                   mfu=base.mfu, hbm_eff=base.hbm_eff,
                   correction=dict(correction))


def make_cost_fn(cost_model: CostModel):
    """Closure form used by scoring: b -> seconds."""
    def c_prefill(b: float) -> float:
        return cost_model.c_prefill(float(b))
    return c_prefill
