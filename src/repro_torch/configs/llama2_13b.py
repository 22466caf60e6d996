"""llama2-13b-chat — the paper's own evaluation model (§6.2)."""
from . import register
from .base import ModelConfig

CONFIG = register(
    ModelConfig(
        name="llama2-13b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=40,
        d_ff=13824, vocab_size=32000, head_dim=128,
        attn_kind="full", rope_theta=10000.0, max_seq_len=4096,
    ),
    smoke=ModelConfig(
        name="llama2-13b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=16,
    ),
)
