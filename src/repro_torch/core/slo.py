"""Service-level objectives and attainment accounting."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple

import numpy as np

from .request import Request


@dataclass(frozen=True)
class SLO:
    ttft: float = 1.5  # seconds, P99 (paper §6.2 uses 1500 ms)
    tpot: float = 0.110  # seconds per output token, P99 (110 ms)


def percentile(xs: Iterable[float], p: float) -> float:
    xs = list(xs)
    if not xs:
        return 0.0
    return float(np.percentile(np.asarray(xs), p))


@dataclass
class ServiceMetrics:
    p99_ttft: float
    p99_tpot: float
    mean_ttft: float
    throughput_tokens_per_s: float  # processed (prefill+decode), paper's metric
    online_throughput: float
    offline_throughput: float
    ttft_slo_attainment: float
    tpot_slo_attainment: float
    num_finished: int
    num_preemptions: int
    online_gen_throughput: float = 0.0  # generated tokens only
    offline_gen_throughput: float = 0.0


def _processed_tokens(r: Request) -> int:
    """Prompt tokens prefilled + tokens generated — the paper's throughput
    metric (its Online-Only baseline of 1999 tok/s at ~2 req/s only adds up
    with prompt tokens counted)."""
    return min(r.num_prefilled, r.prompt_len) + r.num_generated


class SLOTracker:
    """Incremental SLO attainment over live requests (DESIGN.md §15).

    ``summarize`` recomputes attainment from scratch over every request;
    that is fine post-hoc but too expensive to run per engine iteration.
    This tracker consumes each online request's ``ttft`` once and its
    ``token_times`` diffs exactly once (per-request cursors), so repeated
    ``observe`` calls over the same request list do O(new tokens) work and
    the running attainment fractions are *identical* to what ``summarize``
    would report over the same requests — same TTFT values, same TPOT
    diffs, same empty-set convention (attainment 1.0 with no samples).

    ``observe`` returns the newly consumed (ttfts, tpots) so a caller can
    feed latency histograms without re-deriving them.  Works against
    pipelined engines too: ``Request.record_token`` appends ``token_times``
    even for structural commits whose token value arrives later, so timing
    is complete at observation time even when ``output_tokens`` lags.
    """

    def __init__(self, slo: SLO):
        self.slo = slo
        # request_id -> number of token_times already consumed
        self._seen: Dict[int, int] = {}
        self._ttft_done: set = set()
        self.ttft_count = 0
        self.ttft_attained = 0
        self.tpot_count = 0
        self.tpot_attained = 0

    def observe(
        self, requests: Iterable[Request]
    ) -> Tuple[List[float], List[float]]:
        new_ttfts: List[float] = []
        new_tpots: List[float] = []
        for r in requests:
            if not r.is_online:
                continue
            rid = r.request_id
            if rid not in self._ttft_done:
                t = r.ttft
                if t is not None:
                    self._ttft_done.add(rid)
                    self.ttft_count += 1
                    if t <= self.slo.ttft:
                        self.ttft_attained += 1
                    new_ttfts.append(t)
            times = r.token_times
            seen = self._seen.get(rid, 0)
            n = len(times)
            if n > seen:
                for j in range(max(seen, 1), n):
                    dt = times[j] - times[j - 1]
                    self.tpot_count += 1
                    if dt <= self.slo.tpot:
                        self.tpot_attained += 1
                    new_tpots.append(dt)
                self._seen[rid] = n
        return new_ttfts, new_tpots

    @property
    def ttft_attainment(self) -> float:
        return self.ttft_attained / self.ttft_count if self.ttft_count else 1.0

    @property
    def tpot_attainment(self) -> float:
        return self.tpot_attained / self.tpot_count if self.tpot_count else 1.0


def summarize(
    requests: List[Request], slo: SLO, duration: float
) -> ServiceMetrics:
    online = [r for r in requests if r.is_online]
    offline = [r for r in requests if not r.is_online]
    ttfts = [r.ttft for r in online if r.ttft is not None]
    tpots = [t for r in online for t in r.tpots()]
    tok_on = sum(_processed_tokens(r) for r in online)
    tok_off = sum(_processed_tokens(r) for r in offline)
    dur = max(duration, 1e-9)
    return ServiceMetrics(
        p99_ttft=percentile(ttfts, 99),
        p99_tpot=percentile(tpots, 99),
        mean_ttft=float(np.mean(ttfts)) if ttfts else 0.0,
        throughput_tokens_per_s=(tok_on + tok_off) / dur,
        online_throughput=tok_on / dur,
        offline_throughput=tok_off / dur,
        ttft_slo_attainment=(
            sum(1 for t in ttfts if t <= slo.ttft) / len(ttfts) if ttfts else 1.0
        ),
        tpot_slo_attainment=(
            sum(1 for t in tpots if t <= slo.tpot) / len(tpots) if tpots else 1.0
        ),
        num_finished=sum(1 for r in requests if r.finish_time is not None),
        num_preemptions=sum(r.num_preemptions for r in requests),
        online_gen_throughput=sum(r.num_generated for r in online) / dur,
        offline_gen_throughput=sum(r.num_generated for r in offline) / dur,
    )
