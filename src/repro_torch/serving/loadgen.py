"""Load generation: gamma arrival process + BurstGPT-like trace synthesis.

Mirrors the paper's built-in load generator (§5): precisely timed requests
following a gamma process parameterized by (rate, CV); plus the workload
shapes used in §6 — the campus-trace-like bursty profile (Fig. 1b), the
ON/OFF phased load (§6.3.1), and CV / rate sweeps (§6.3.2).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.request import Priority, Request


@dataclass(frozen=True)
class LengthSpec:
    prompt_len: int = 1024  # §6.3 representative online value
    output_len: int = 128
    prompt_jitter: float = 0.0  # +- fraction (uniform)
    output_jitter: float = 0.0


def _lengths(spec: LengthSpec, rng: np.random.Generator) -> Tuple[int, int]:
    def j(base: int, frac: float) -> int:
        if frac <= 0:
            return base
        lo, hi = int(base * (1 - frac)), int(base * (1 + frac))
        return int(rng.integers(max(1, lo), max(2, hi + 1)))

    return j(spec.prompt_len, spec.prompt_jitter), j(spec.output_len, spec.output_jitter)


def gamma_arrivals(
    rate: float,
    cv: float,
    duration: float,
    rng: np.random.Generator,
    start: float = 0.0,
) -> List[float]:
    """Arrival times of a gamma renewal process: mean gap 1/rate, CV as given
    (CV=1 -> Poisson)."""
    if rate <= 0:
        return []
    shape = 1.0 / (cv * cv)
    scale = 1.0 / (rate * shape)
    times, t = [], start
    # generate in bulk then trim
    n_est = int(rate * duration * 2 + 16)
    while True:
        gaps = rng.gamma(shape, scale, size=n_est)
        for g in gaps:
            t += g
            if t >= start + duration:
                return times
            times.append(t)


def make_online_requests(
    times: Sequence[float],
    lengths: LengthSpec,
    rng: np.random.Generator,
) -> List[Request]:
    out = []
    for t in times:
        p, o = _lengths(lengths, rng)
        out.append(
            Request(Priority.ONLINE, prompt_len=p, max_new_tokens=o, arrival_time=t)
        )
    return out


def make_offline_batch(
    n: int,
    lengths: LengthSpec,
    rng: np.random.Generator,
    arrival_time: float = 0.0,
) -> List[Request]:
    """A Batch-API submission: n best-effort requests available immediately
    (document summarization style: long prompts, moderate outputs)."""
    out = []
    for _ in range(n):
        p, o = _lengths(lengths, rng)
        out.append(
            Request(
                Priority.OFFLINE,
                prompt_len=p,
                max_new_tokens=o,
                arrival_time=arrival_time,
            )
        )
    return out


def attach_prompts(
    reqs: Sequence[Request], vocab_size: int, rng: np.random.Generator
) -> List[Request]:
    """Give trace requests concrete prompt token ids (in place).

    Simulated-time engines schedule on lengths alone; the real-execution
    runtime (``serving.runtime``) feeds the same traces through actual
    compute and therefore needs token ids.  Random ids are the right
    workload for timing (serving cost depends on shape, not content).
    """
    for r in reqs:
        if r.prompt is None:
            r.prompt = rng.integers(0, vocab_size, r.prompt_len).astype(np.int32)
    return list(reqs)


# ---------------------------------------------------------------------------
# Workload profiles from the paper's evaluation
# ---------------------------------------------------------------------------


def burstgpt_like_rate_profile(t: float, base_rate: float) -> float:
    """A 15-minute window with minute-scale fluctuation and a 3× burst around
    minute 10 (Fig. 1b).  Deterministic shape; stochasticity comes from the
    gamma sampling on top."""
    minute = t / 60.0
    wiggle = 1.0 + 0.35 * np.sin(minute * 2.1) + 0.2 * np.sin(minute * 5.7 + 1.0)
    burst = 3.0 if 9.5 <= minute < 11.0 else 1.0
    lull = 0.4 if 4.0 <= minute < 5.5 else 1.0
    return max(0.05, base_rate * wiggle * burst * lull)


def inhomogeneous_arrivals(
    rate_fn: Callable[[float], float],
    peak_rate: float,
    duration: float,
    rng: np.random.Generator,
) -> List[float]:
    """Thinning sampler for a time-varying Poisson process."""
    times, t = [], 0.0
    while t < duration:
        t += rng.exponential(1.0 / peak_rate)
        if t >= duration:
            break
        if rng.uniform() < rate_fn(t) / peak_rate:
            times.append(t)
    return times


def onoff_arrivals(
    rate: float,
    on_len: float,
    off_len: float,
    duration: float,
    rng: np.random.Generator,
) -> List[float]:
    """ON/OFF phased load (§6.3.1): max-capacity ON phases, silent OFF."""
    times = []
    t0 = 0.0
    while t0 < duration:
        times += gamma_arrivals(rate, 1.0, min(on_len, duration - t0), rng, t0)
        t0 += on_len + off_len
    return sorted(times)
