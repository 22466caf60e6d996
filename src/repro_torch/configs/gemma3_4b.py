"""gemma3-4b — 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt; unverified].  head_dim=256 (gemma3 convention)."""
from . import register
from .base import ModelConfig

CONFIG = register(
    ModelConfig(
        name="gemma3-4b", family="dense",
        n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
        d_ff=10240, vocab_size=262144, head_dim=256,
        attn_kind="local_global", local_global_period=6, window=1024,
        pattern=("local", "local", "local", "local", "local", "global"),
        rope_theta=1_000_000.0, tie_embeddings=True,
        subquadratic=True,   # 5/6 layers bounded-window; global layers use
                             # the seq-sharded flash-decode path (DESIGN §5)
        max_seq_len=524_288,
    ),
    smoke=ModelConfig(
        name="gemma3-4b-smoke", family="dense",
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        attn_kind="local_global", local_global_period=6, window=16,
        pattern=("local", "local", "local", "local", "local", "global"),
        tie_embeddings=True, subquadratic=True,
    ),
)
