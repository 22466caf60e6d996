"""internvl2-76b — InternViT + InternLM2 VLM backbone [arXiv:2404.16821;
unverified].  The ViT frontend is a stub: train/prefill consume precomputed
patch embeddings (B, S, d_model); decode generates text tokens."""
from . import register
from .base import ModelConfig

CONFIG = register(
    ModelConfig(
        name="internvl2-76b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=28672, vocab_size=128256, head_dim=128,
        attn_kind="full", rope_theta=1_000_000.0,
        input_mode="embeddings",
    ),
    smoke=ModelConfig(
        name="internvl2-76b-smoke", family="vlm",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        input_mode="embeddings",
    ),
)
