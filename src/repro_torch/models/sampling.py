"""Token sampling: greedy / temperature / top-k.

Greedy sampling keeps preempted and uninterrupted runs byte-identical
(DESIGN.md §7).  Stochastic sampling draws from an explicit
``torch.Generator``; it cannot reproduce ``jax.random`` draws, so it is
held to the reference by its distribution only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 -> greedy
    top_k: int = 0  # 0 -> no truncation
    max_new_tokens: int = 128
    stop_token: int = -1  # -1 -> never stop early


def sample(
    logits: torch.Tensor,  # (B, V)
    params: SamplingParams,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Returns next token ids (B,) int32."""
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / params.temperature
    if params.top_k:
        kth = torch.topk(logits, params.top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def sample_rows(
    logits: torch.Tensor,  # (S, V) per-sequence last-token logits
    rows: torch.Tensor,  # (B,) sequence rows to sample
    params: SamplingParams,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Gather-then-sample: (B,) int32."""
    return sample(logits[rows.long()], params, generator)
