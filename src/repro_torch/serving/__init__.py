"""Serving substrate of the port: paged KV accounting, the slot-based
continuous-batching engine, the sampler and the ``serve`` facade."""
from .api import serve
from .engine import EngineConfig, ServingEngine
from .kv_cache import BlockPool, SlotAllocator
from .sampler import sample_tokens

__all__ = ["serve", "EngineConfig", "ServingEngine", "BlockPool", "SlotAllocator",
           "sample_tokens"]
