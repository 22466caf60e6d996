"""ModelConfig — one schema covering all ten assigned architecture families.

Every assigned architecture (DESIGN.md §5) is expressed as an instance of
this dataclass; the model assembly (models/model.py) reads only this config.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    """One architecture's shape and variant flags, read by the model assembly."""
    name: str
    family: str                      # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 → d_model // n_heads

    # ---- attention variants ----
    attn_kind: str = "full"          # full | swa | local_global
    window: int = 4096               # SWA / local window
    local_global_period: int = 0     # gemma3: 6 (5 local + 1 global)
    qk_norm: bool = False            # qwen3
    rope_theta: float = 10000.0
    causal: bool = True              # False for encoder-only

    # ---- MLA (deepseek-v2 / minicpm3) ----
    use_mla: bool = False
    kv_lora_rank: int = 0
    rope_head_dim: int = 64
    v_head_dim: int = 0              # 0 → head_dim

    # ---- MoE ----
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 2
    moe_d_ff: int = 0                # per-expert hidden (0 → d_ff)
    capacity_factor: float = 1.25
    first_dense_layers: int = 0      # deepseek: first layer is dense MLP

    # ---- SSM (mamba2) ----
    ssm_state: int = 0
    ssm_head_dim: int = 64
    d_inner: int = 0                 # 0 → 2 * d_model
    ssm_chunk: int = 256
    conv_width: int = 4
    ssm_groups: int = 1

    # ---- hybrid layer pattern (recurrentgemma) ----
    # Pattern of per-layer kinds within one period; empty → homogeneous.
    # Kinds: "attn", "rglru", "ssm", "moe", "local", "global"
    pattern: tuple = ()
    rnn_width: int = 0               # RG-LRU width (0 → d_model)

    # ---- I/O mode ----
    input_mode: str = "tokens"       # tokens | embeddings (vlm/audio stubs)
    is_encoder_only: bool = False
    tie_embeddings: bool = False

    # ---- capability flags for the dry-run matrix ----
    subquadratic: bool = False       # eligible for long_500k
    max_seq_len: int = 131072

    # ---- numerics ----
    norm_eps: float = 1e-6
    logit_softcap: float = 0.0       # gemma-style final softcap (0 = off)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.d_inner == 0 and self.family == "ssm":
            object.__setattr__(self, "d_inner", 2 * self.d_model)
        if self.moe_d_ff == 0 and self.n_experts:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if self.v_head_dim == 0:
            object.__setattr__(self, "v_head_dim", self.head_dim)
        if self.rnn_width == 0:
            object.__setattr__(self, "rnn_width", self.d_model)
        if not self.pattern:
            kind = {"ssm": "ssm"}.get(self.family, "attn")
            if self.family == "moe":
                kind = "attn"        # attn + moe mlp handled per-layer
            object.__setattr__(self, "pattern", (kind,))

    # ---- derived sizes ----

    @property
    def n_ssm_heads(self) -> int:
        """Number of SSM heads (``d_inner // ssm_head_dim``)."""
        return self.d_inner // self.ssm_head_dim

    @property
    def kv_cache_dims_per_token(self) -> int:
        """Per-layer, per-token KV cache width (elements)."""
        if self.use_mla:
            return self.kv_lora_rank + self.rope_head_dim   # latent cache
        return 2 * self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (dense estimate; used for rooflines)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd, H, K = self.head_dim, self.n_heads, self.n_kv_heads
        n = V * d * (1 if self.tie_embeddings else 2)
        kinds = [self.pattern[i % len(self.pattern)] for i in range(self.n_layers)]
        for i, kind in enumerate(kinds):
            if kind in ("attn", "local", "global"):
                if self.use_mla:
                    r = self.kv_lora_rank
                    per = (d * H * hd                      # q
                           + d * (r + self.rope_head_dim)  # kv down
                           + r * H * (hd + self.v_head_dim)  # kv up
                           + H * self.v_head_dim * d)      # o
                else:
                    per = d * H * hd + 2 * d * K * hd + H * hd * d
            elif kind == "rglru":
                w = self.rnn_width
                per = 2 * d * w + w * d + 3 * w
            elif kind == "ssm":
                di, N = self.d_inner, self.ssm_state
                per = d * (2 * di + 2 * self.ssm_groups * N + self.n_ssm_heads) + di * d
            else:
                per = 0
            n += per
            # MLP
            if self.n_experts and i >= self.first_dense_layers and kind != "ssm":
                e_ff = self.moe_d_ff
                n += (self.n_experts + self.n_shared_experts) * 3 * d * e_ff
                n += d * self.n_experts               # router
            elif kind == "ssm":
                pass                                   # mamba blocks have no MLP
            else:
                mult = 2 if self.is_encoder_only else 3   # GeLU vs SwiGLU
                n += mult * d * ff
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE top-k slice) — used for MODEL_FLOPS."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        d = self.d_model
        moe_layers = max(self.n_layers - self.first_dense_layers, 0)
        all_experts = moe_layers * self.n_experts * 3 * d * self.moe_d_ff
        active = moe_layers * self.moe_top_k * 3 * d * self.moe_d_ff
        return full - all_experts + active

    def scaled(self, **overrides) -> "ModelConfig":
        """Copy of this config with the given fields replaced."""
        return replace(self, **overrides)
