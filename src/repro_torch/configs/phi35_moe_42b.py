"""phi3.5-moe-42b-a6.6b — 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct; hf]."""
from . import register
from .base import ModelConfig

CONFIG = register(
    ModelConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=6400, vocab_size=32064, head_dim=128,
        n_experts=16, moe_top_k=2, moe_d_ff=6400,
        attn_kind="full", rope_theta=10000.0,
    ),
    smoke=ModelConfig(
        name="phi3.5-moe-42b-a6.6b-smoke", family="moe",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab_size=256, head_dim=16,
        n_experts=4, moe_top_k=2, moe_d_ff=96,
    ),
)
