"""Model path of the port: dense attention families (GQA with RoPE,
optional ``qk_norm``; causal, windowed or bidirectional), MLA attention,
SwiGLU, GeLU and MoE MLPs, the Mamba-2 SSM family, the RG-LRU hybrid
family, token or embedding inputs, prefill (per-position logits for an
encoder), slot decode, chunked prefill, and the training loss of the
attention families."""

from .common import DtypePolicy
from .model import (LMParams, chunk_step, decode_step, init_decode_caches,
                    init_params, prefill, train_loss)
from .transformer import layer_kinds, stack_layout, supports_chunked_decode

__all__ = [
    "DtypePolicy", "LMParams", "init_params", "prefill", "decode_step",
    "chunk_step", "init_decode_caches", "layer_kinds", "stack_layout",
    "supports_chunked_decode", "train_loss",
]
