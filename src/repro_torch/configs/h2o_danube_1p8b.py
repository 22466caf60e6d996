"""h2o-danube-1.8b — llama+mistral mix, sliding-window attention
[arXiv:2401.16818; hf]."""
from . import register
from .base import ModelConfig

CONFIG = register(
    ModelConfig(
        name="h2o-danube-1.8b", family="dense",
        n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
        d_ff=6912, vocab_size=32000, head_dim=80,
        attn_kind="swa", window=4096, rope_theta=10000.0,
        subquadratic=True,       # SWA: decode memory bounded by the window
        max_seq_len=524_288,
    ),
    smoke=ModelConfig(
        name="h2o-danube-1.8b-smoke", family="dense",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        attn_kind="swa", window=32, subquadratic=True,
    ),
)
