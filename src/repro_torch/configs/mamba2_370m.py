"""mamba2-370m — SSD (state-space duality) [arXiv:2405.21060; unverified]."""
from . import register
from .base import ModelConfig

CONFIG = register(
    ModelConfig(
        name="mamba2-370m", family="ssm",
        n_layers=48, d_model=1024, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_head_dim=64, d_inner=2048, ssm_chunk=256,
        pattern=("ssm",), subquadratic=True, tie_embeddings=True,
        max_seq_len=1_048_576,
    ),
    smoke=ModelConfig(
        name="mamba2-370m-smoke", family="ssm",
        n_layers=4, d_model=64, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab_size=256,
        ssm_state=16, ssm_head_dim=16, d_inner=128, ssm_chunk=32,
        pattern=("ssm",), subquadratic=True, tie_embeddings=True,
    ),
)
