"""Config registry: ``get_config(arch_id)`` / ``get_smoke_config(arch_id)``.

The port registers every architecture of the JAX package: the paper's own
evaluation model (llama2-13b), qwen3-4b (GQA with ``qk_norm``), mamba2-370m
(the SSM family), deepseek-v2-lite-16b (MLA attention and MoE experts),
minicpm3-4b (MLA attention, dense MLPs), h2o-danube-1.8b (sliding-window
attention), gemma3-4b (five local sliding-window layers to one global),
recurrentgemma-9b (two RG-LRU layers to one local MQA layer),
phi3.5-moe-42b-a6.6b (GQA, 16 experts top-2, no shared experts),
hubert-xlarge (a bidirectional encoder over frame embeddings, GeLU MLPs,
per-position logits) and internvl2-76b (a GQA decoder whose prefill takes
embeddings).  Smoke configs are reduced same-family variants for CPU
tests.
"""

from __future__ import annotations

from .base import ModelConfig

_REGISTRY: dict = {}
_SMOKE: dict = {}


def register(cfg: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    """Register a full config and its smoke variant under ``cfg.name``."""
    _REGISTRY[cfg.name] = cfg
    _SMOKE[cfg.name] = smoke
    return cfg


def get_config(name: str) -> ModelConfig:
    """The full published config of architecture ``name``."""
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def get_smoke_config(name: str) -> ModelConfig:
    """The reduced same-family config of architecture ``name``."""
    _ensure_loaded()
    return _SMOKE[name]


def list_archs() -> list[str]:
    """Names of every registered architecture."""
    _ensure_loaded()
    return sorted(_REGISTRY)


_loaded = False


def _ensure_loaded():
    global _loaded
    if _loaded:
        return
    from . import (deepseek_v2_lite_16b, gemma3_4b, h2o_danube_1p8b,
                   hubert_xlarge, internvl2_76b, llama2_13b, mamba2_370m,
                   minicpm3_4b, phi35_moe_42b, qwen3_4b, recurrentgemma_9b)
    # imported for their registration side effect only
    _ = (deepseek_v2_lite_16b, gemma3_4b, h2o_danube_1p8b, hubert_xlarge,
         internvl2_76b, llama2_13b, mamba2_370m, minicpm3_4b, phi35_moe_42b,
         qwen3_4b, recurrentgemma_9b)
    _loaded = True
