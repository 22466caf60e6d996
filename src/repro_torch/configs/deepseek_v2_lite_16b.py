"""deepseek-v2-lite-16b — MLA kv_lora=512, shared+routed MoE top-6
[arXiv:2405.04434; hf].  DeepSeek-V2-Lite has 64 routed experts and 2
shared ones (the 160 routed experts belong to the full V2)."""
from . import register
from .base import ModelConfig

CONFIG = register(
    ModelConfig(
        name="deepseek-v2-lite-16b", family="moe",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=10944, vocab_size=102400, head_dim=128,
        use_mla=True, kv_lora_rank=512, rope_head_dim=64,
        n_experts=64, n_shared_experts=2, moe_top_k=6, moe_d_ff=1408,
        first_dense_layers=1,
        attn_kind="full", rope_theta=10000.0,
    ),
    smoke=ModelConfig(
        name="deepseek-v2-lite-16b-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=16,
        use_mla=True, kv_lora_rank=32, rope_head_dim=8,
        n_experts=8, n_shared_experts=1, moe_top_k=2, moe_d_ff=48,
        first_dense_layers=1,
    ),
)
