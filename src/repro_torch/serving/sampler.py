"""Token sampling: greedy, or temperature / top-k from an explicit
``torch.Generator``."""

from __future__ import annotations

import torch


def sample_tokens(logits: torch.Tensor, generator: torch.Generator | None = None,
                  *, temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits (B, 1, V) → tokens (B, 1) int32.  ``temperature <= 0`` is
    greedy (first maximal index, as ``jnp.argmax``) and needs no generator;
    otherwise tokens are drawn from ``generator``, which must live on the
    logits' device."""
    lg = logits[:, 0, :]
    if temperature <= 0.0:
        return lg.argmax(dim=-1, keepdim=True).to(torch.int32)
    if generator is None:
        raise ValueError("sampling at temperature > 0 needs a generator")
    lg = lg.float() / temperature
    if top_k and top_k > 0:
        kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
        lg = lg.masked_fill(lg < kth, float("-inf"))
    probs = torch.softmax(lg, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)
