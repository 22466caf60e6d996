"""Config registry: ``get_config(arch_id)`` / ``get_smoke_config(arch_id)``.

The port registers the architectures its model path supports so far: the
paper's own evaluation model (llama2-13b), qwen3-4b (GQA with ``qk_norm``)
and mamba2-370m (the SSM family).  Smoke configs are reduced same-family variants for CPU tests.
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
    from . import llama2_13b, mamba2_370m, qwen3_4b
    # imported for their registration side effect only
    _ = (llama2_13b, mamba2_370m, qwen3_4b)
    _loaded = True
