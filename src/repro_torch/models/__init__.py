"""Model path of the port: dense attention families (GQA with RoPE,
optional ``qk_norm``), MLA attention, SwiGLU and MoE MLPs, the Mamba-2 SSM
family, prefill, slot decode and chunked prefill."""

from .common import DtypePolicy
from .model import (LMParams, chunk_step, decode_step, init_decode_caches,
                    init_params, prefill)
from .transformer import layer_kinds, stack_layout, supports_chunked_decode

__all__ = [
    "DtypePolicy", "LMParams", "init_params", "prefill", "decode_step",
    "chunk_step", "init_decode_caches", "layer_kinds", "stack_layout",
    "supports_chunked_decode",
]
