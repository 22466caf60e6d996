"""recurrentgemma-9b — RG-LRU + local attention, 2:1 recurrent:attention
(Griffin pattern: rglru, rglru, local-attn) [arXiv:2402.19427; unverified].
MQA (kv=1), head_dim=256, local window 2048."""
from . import register
from .base import ModelConfig

CONFIG = register(
    ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
        d_ff=12288, vocab_size=256000, head_dim=256,
        pattern=("rglru", "rglru", "local"), window=2048,
        rnn_width=4096, tie_embeddings=True,
        subquadratic=True, max_seq_len=1_048_576,
        rope_theta=10000.0,
    ),
    smoke=ModelConfig(
        name="recurrentgemma-9b-smoke", family="hybrid",
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=128, vocab_size=256, head_dim=16,
        pattern=("rglru", "rglru", "local"), window=16,
        rnn_width=64, tie_embeddings=True, subquadratic=True,
    ),
)
