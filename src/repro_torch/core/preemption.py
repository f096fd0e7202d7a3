"""Layer-granularity preemption safepoints (§4.3), TPU-adapted.

On GPU the paper instruments the model with an in-graph safepoint every K
layers (NCCL-broadcast flag + abort).  TPUs execute one program per
dispatch, so the natural safepoint is the *dispatch boundary*: the worker
executes the forward pass as a sequence of jitted K-layer segments
(``transformer.run_tokens_paged_at`` on the fused paged path, where every
pure-offline iteration — prefill chunks and decodes fused into one ragged
batch — is segment-dispatched, DESIGN.md §12; ``transformer.run_segment``
/ ``run_segment_paged_at`` on the split paths) and checks a host-side
flag between dispatches (JAX async dispatch keeps the device busy during
the check); on the split paged path, batched-prefill group boundaries are
safepoints too (``RealEngine._prefill_paged_batched``, DESIGN.md §9).
The wall-clock runtime additionally drains API-thread
arrivals at every check via the engine's ``arrival_poll`` hook
(DESIGN.md §10).  Semantics match the paper exactly:

* safepoints are armed only for pure-offline batches ("preemptible" flag
  passed by the scheduler) — co-serving batches are already budget-bounded;
* on preemption the partial iteration is discarded; the KV cache of
  previously completed tokens is untouched (inference is stateless per
  token), so nothing needs recovery beyond rescheduling;
* granularity K (``safepoint_interval``) trades responsiveness against
  per-check overhead (paper: K=8, 988µs/check, 5.41ms response).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional


class PreemptionFlag:
    """Host-side shared flag (scheduler writes, worker polls).

    Thread-safe: the streaming API may set it from the arrival thread while
    the worker loop polls between segment dispatches.
    """

    def __init__(self):
        self._flag = threading.Event()

    def set(self) -> None:
        self._flag.set()

    def clear(self) -> None:
        self._flag.clear()

    def is_set(self) -> bool:
        return self._flag.is_set()


@dataclass
class SafepointStats:
    checks: int = 0
    preemptions: int = 0
    check_seconds: float = 0.0  # cumulative host-side check overhead

    @property
    def mean_check_us(self) -> float:
        return 1e6 * self.check_seconds / self.checks if self.checks else 0.0


@dataclass
class SegmentedExecution:
    """Run ``segments`` callables with safepoint checks in between.

    Returns (completed: bool, segments_done: int).  Each segment callable
    performs one K-layer dispatch and returns nothing (state is threaded by
    the caller's closure).  ``on_safepoint`` is invoked between segments —
    the engine uses it to drain arrivals and run Algorithm 2.
    """

    flag: PreemptionFlag
    stats: SafepointStats = field(default_factory=SafepointStats)

    def run(
        self,
        segments: List[Callable[[], None]],
        preemptible: bool,
        on_safepoint: Optional[Callable[[int], None]] = None,
    ) -> tuple:
        for i, seg in enumerate(segments):
            if preemptible and i > 0:
                t0 = time.perf_counter()
                if on_safepoint is not None:
                    on_safepoint(i)
                hit = self.flag.is_set()
                self.stats.checks += 1
                self.stats.check_seconds += time.perf_counter() - t0
                if hit:
                    self.stats.preemptions += 1
                    return False, i
            seg()
        return True, len(segments)
