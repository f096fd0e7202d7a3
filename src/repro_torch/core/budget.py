"""Token-budget arithmetic (``calc_budget`` in Algorithm 1).

The budget for one iteration is the largest batch (in tokens) whose
estimated execution time still meets the latency objective:

* batches containing decode-phase online requests must finish within the
  TPOT objective (every running online sequence produces its next token
  within t_TPOT);
* prefill-only additions must keep queued online prefills within t_TTFT.

Inverted from the latency model by binary search (the model is monotone in
every token count).
"""
from __future__ import annotations

from dataclasses import dataclass

from .profiler import BatchShape, LatencyModel
from .slo import SLO


def pow2_bucket(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor).

    THE shape-bucketing primitive (DESIGN.md §9/§12): every jitted serving
    entry point pads its variable dimension to one of these buckets so jit
    retraces are bounded by the bucket count instead of workload variety —
    decode batch sizes (floor 1), prefill chunk lengths (floor 8),
    checkpoint/restore block-id lists (floor 1), and the fused ragged
    token batch (token count, sequence count and max query length, all
    floor 1)."""
    b = max(1, floor)
    while b < n:
        b *= 2
    return b


@dataclass(frozen=True)
class TokenBudget:
    max_total_tokens: int  # hard cap for this iteration
    max_seqs: int

    def remaining(self, scheduled_tokens: int) -> int:
        return max(0, self.max_total_tokens - scheduled_tokens)

    def over_budget(self, scheduled_tokens: int) -> bool:
        return scheduled_tokens > self.max_total_tokens


def max_tokens_within(
    model: LatencyModel,
    base: BatchShape,
    target_seconds: float,
    *,
    avg_ctx: int = 1024,
    hi: int = 1 << 17,
) -> int:
    """Largest number of *additional* decode-equivalent tokens that can join
    ``base`` while keeping iter_time <= target."""
    if model.iter_time(base) > target_seconds:
        return 0

    def time_with(extra: int) -> float:
        add = BatchShape(
            prefill_tokens=extra,
            prefill_attn_tokens=float(extra) * avg_ctx,
            prefill_ctx_end=extra,
            num_seqs=max(1, extra // 256),
        )
        return model.iter_time(base.merge(add))

    lo, hi_ = 0, hi
    if time_with(hi_) <= target_seconds:
        return hi_
    while lo < hi_:
        mid = (lo + hi_ + 1) // 2
        if time_with(mid) <= target_seconds:
            lo = mid
        else:
            hi_ = mid - 1
    return lo


def calc_budget(
    model: LatencyModel,
    slo: SLO,
    *,
    has_decode: bool,
    avg_ctx: int = 1024,
    max_seqs: int = 512,
    headroom: float = 0.8,
    min_tokens: int = 256,
) -> TokenBudget:
    """Algorithm 1 line 10.  ``headroom`` keeps estimation error from eating
    the whole objective (the paper's profiler is also conservative).

    Every co-serving iteration is bounded by the TPOT objective, not just
    batches that literally contain a decode token: a bounded per-iteration
    duration is what bounds the *queueing* delay of the next online arrival
    (the reason the paper adopts chunked prefill in the first place).  The
    looser TTFT bound applies only as a floor so huge online prompts still
    make progress (``min_tokens``)."""
    del has_decode  # retained for API compatibility; see docstring
    target = slo.tpot * headroom
    n = max_tokens_within(model, BatchShape(), target, avg_ctx=avg_ctx)
    return TokenBudget(max_total_tokens=max(min_tokens, n), max_seqs=max_seqs)
