"""Model path of the port: dense attention families (GQA with RoPE,
optional ``qk_norm``), SwiGLU MLPs, the Mamba-2 SSM family, prefill and
slot decode."""

from .common import DtypePolicy
from .model import LMParams, decode_step, init_decode_caches, init_params, prefill
from .transformer import layer_kinds, stack_layout

__all__ = [
    "DtypePolicy", "LMParams", "init_params", "prefill", "decode_step",
    "init_decode_caches", "layer_kinds", "stack_layout",
]
