"""qwen3-4b — qk_norm, GQA, head_dim=128 [hf:Qwen/Qwen3-8B; hf]."""
from . import register
from .base import ModelConfig

CONFIG = register(
    ModelConfig(
        name="qwen3-4b", family="dense",
        n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
        d_ff=9728, vocab_size=151936, head_dim=128,
        qk_norm=True, attn_kind="full", rope_theta=1_000_000.0,
    ),
    smoke=ModelConfig(
        name="qwen3-4b-smoke", family="dense",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16, qk_norm=True,
    ),
)
