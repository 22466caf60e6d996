"""hubert-xlarge — encoder-only audio transformer [arXiv:2106.07447;
unverified].  Modality frontend is a stub: input_specs() provides
precomputed frame embeddings (B, S, d_model)."""
from . import register
from .base import ModelConfig

CONFIG = register(
    ModelConfig(
        name="hubert-xlarge", family="encoder",
        n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
        d_ff=5120, vocab_size=504, head_dim=80,
        causal=False, is_encoder_only=True, input_mode="embeddings",
    ),
    smoke=ModelConfig(
        name="hubert-xlarge-smoke", family="encoder",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=32, head_dim=16,
        causal=False, is_encoder_only=True, input_mode="embeddings",
    ),
)
