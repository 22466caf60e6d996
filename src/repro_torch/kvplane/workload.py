"""Multi-turn / agentic shared-prefix workload generator.

The traffic class the KV plane exists for: conversations and agent loops
re-send an ever-growing prefix (system prompt + prior turns) on every
request, so a long prompt with a 90%-cached prefix *behaves like a short
job* — the service-time signal EWSJF's effective-workload scoring exploits.

Model:

* one **shared system prompt** across every session (the classic fleet-hot
  prefix);
* per **session**, turns arrive sequentially: turn *t*'s prompt is the full
  history (system + all prior user turns and sampled assistant replies)
  plus the new user text, so consecutive turns share all but the tail;
* optional **branching** (agentic fan-out): a turn may fork a parallel
  branch that continues from the same history — tree-shaped reuse, not
  just chains;
* every request carries ``prompt_hashes`` — the chained token-block hashes
  (``kvplane.radix.chain_block_hashes``) of its synthetic token stream —
  which is all the radix index ever sees.

Synthetic tokens are ints: system tokens are globally shared ids; session
tokens are namespaced by session so distinct conversations never alias.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.types import Request
from .radix import chain_block_hashes, mix_hash

_SESSION_NS = 1 << 24


@dataclass
class SharedPrefixWorkloadSpec:
    """Multi-turn / agentic session generator: shared system prompt,
    growing per-session histories, optional branching."""
    n_sessions: int = 32
    turns_per_session: int = 6
    session_rate: float = 2.0        # session starts / s (Poisson)
    think_time: float = 2.0          # mean gap between a reply and next turn
    system_prompt_len: int = 512     # tokens shared by every session
    user_turn_range: tuple[int, int] = (16, 96)
    branch_prob: float = 0.0         # chance a turn forks a parallel branch
    mean_output_tokens: float = 48.0
    max_new_tokens: int = 128
    block_size: int = 16
    seed: int = 0

    def generate(self) -> list[Request]:
        """Materialize the session tree as arrival-sorted ``Request``s with
        chained block hashes."""
        rng = np.random.default_rng(self.seed)
        sys_tokens = list(range(1, self.system_prompt_len + 1))
        starts = np.cumsum(rng.exponential(1.0 / self.session_rate,
                                           size=self.n_sessions))
        reqs: list[Request] = []
        next_ns = [1]                    # session-token namespace counter

        def fresh_ns() -> int:
            ns = next_ns[0]
            next_ns[0] += 1
            return ns

        # Each branch is (history tokens, namespace, clock, turns left).
        for sid in range(self.n_sessions):
            branches = [(list(sys_tokens), fresh_ns(), float(starts[sid]),
                         self.turns_per_session)]
            while branches:
                history, ns, clock, left = branches.pop()
                if left <= 0:
                    continue
                ulen = int(rng.integers(self.user_turn_range[0],
                                        self.user_turn_range[1] + 1))
                base = len(history)
                user = [ns * _SESSION_NS + base + j for j in range(ulen)]
                prompt = history + user
                out = int(np.clip(rng.geometric(
                    1.0 / self.mean_output_tokens), 1, self.max_new_tokens))
                reqs.append(Request(
                    prompt_len=len(prompt), arrival_time=clock,
                    max_new_tokens=out, session_id=ns,
                    prompt_hashes=chain_block_hashes(prompt,
                                                     self.block_size)))
                reply = [ns * _SESSION_NS + base + ulen + j
                         for j in range(out)]
                nxt = prompt + reply
                t_next = clock + float(rng.exponential(self.think_time))
                if left > 1 and rng.random() < self.branch_prob:
                    # Fork: a parallel branch continues from the same
                    # history under its own namespace (so its new tokens
                    # never alias the trunk's) on its own clock.
                    branches.append((
                        list(nxt), fresh_ns(),
                        clock + float(rng.exponential(self.think_time)),
                        left - 1))
                branches.append((nxt, ns, t_next, left - 1))
        reqs.sort(key=lambda r: r.arrival_time)
        return reqs


def unique_hashes_for(reqs: list[Request], block_size: int = 16,
                      seed: int = 0x0DD) -> None:
    """Stamp ``prompt_hashes`` with *unique* chains onto requests that have
    none (e.g. a background ``WorkloadSpec`` batch) so a cache-enabled fleet
    treats them honestly: they occupy index space but never hit."""
    for i, r in enumerate(reqs):
        if r.prompt_hashes is None:
            base = mix_hash(seed, i + 1)
            r.prompt_hashes = chain_block_hashes(
                [base + j for j in range(int(r.prompt_len))], block_size)


def agentic_mix(spec: SharedPrefixWorkloadSpec, background: list[Request],
                block_size: int = 16) -> list[Request]:
    """Shared-prefix sessions interleaved with unique background traffic
    (the bench's 'agentic + interactive' scenario), sorted by arrival."""
    unique_hashes_for(background, block_size=block_size)
    merged = spec.generate() + background
    merged.sort(key=lambda r: r.arrival_time)
    return merged
