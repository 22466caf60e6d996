"""minicpm3-4b — MLA attention [hf:openbmb/MiniCPM3-4B; hf]."""
from . import register
from .base import ModelConfig

CONFIG = register(
    ModelConfig(
        name="minicpm3-4b", family="dense",
        n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
        d_ff=6400, vocab_size=73448, head_dim=64,
        use_mla=True, kv_lora_rank=256, rope_head_dim=32,
        attn_kind="full", rope_theta=10000.0,
    ),
    smoke=ModelConfig(
        name="minicpm3-4b-smoke", family="dense",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=16,
        use_mla=True, kv_lora_rank=32, rope_head_dim=8,
    ),
)
