"""Lock-light serving metrics: counters, gauges, histograms (DESIGN.md §15).

The registry is built for one dominant writer — the engine thread — and any
number of reader threads (the bench scraper, the ``serve.py --metrics-port``
endpoint, tests).  Python scalar assignment is atomic under the GIL, so the
hot path (``Counter.inc`` / ``Gauge.set`` / ``Histogram.observe``) takes no
lock at all; the registry's small lock guards only *structure* (creating a
metric the first time a name is seen).  Consequences, documented as the
consistency contract:

* every individual value read by ``snapshot()`` is a value some writer
  actually wrote (no torn reads of Python floats/ints);
* counters are monotone non-decreasing as observed by any single reader;
* there is **no consistent cut across metrics** — a snapshot may pair an
  ``iterations_total`` from step N with a ``queue_depth_online`` from step
  N+1.  Readers that need cross-metric invariants must tolerate one step of
  skew (the bench's ``--assert-metrics`` checks are written this way).

Histograms use fixed bucket bounds chosen at registration, a bisect per
observe, and expose count/sum plus approximate percentiles reconstructed
from bucket midpoints — enough for TTFT/TPOT dashboards without keeping
unbounded sample lists on the engine thread.
"""
from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple


class Counter:
    """Monotone counter.  ``inc`` for event-at-a-time accounting; ``set_to``
    for publishing an externally maintained monotone accumulator (e.g. the
    engine's ``steps``) — it refuses to go backwards."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        self.value += n

    def set_to(self, v: float) -> None:
        if v > self.value:
            self.value = v

    def get(self) -> float:
        return self.value


class Gauge:
    """Point-in-time value (queue depth, occupancy, attainment)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def get(self) -> float:
        return self.value


# Default bounds suit sub-second latencies (TTFT/TPOT in seconds).
_DEFAULT_BOUNDS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class Histogram:
    """Fixed-bucket histogram with approximate percentiles.

    ``observe`` appends to a per-bucket count via one bisect — no allocation,
    no lock.  Percentiles are reconstructed from bucket midpoints (the
    overflow bucket reports its lower bound), so they are approximate by
    design; exact latency accounting stays in ``core.slo.summarize``.
    """

    __slots__ = ("name", "bounds", "counts", "count", "sum")

    def __init__(self, name: str, bounds: Sequence[float] = _DEFAULT_BOUNDS):
        self.name = name
        self.bounds: Tuple[float, ...] = tuple(sorted(bounds))
        # one extra overflow bucket past the last bound
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v

    def percentile(self, p: float) -> float:
        """Approximate percentile from bucket midpoints (0 if empty)."""
        total = self.count
        if total <= 0:
            return 0.0
        rank = max(1, int(p / 100.0 * total + 0.5))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                if i == len(self.bounds):  # overflow bucket
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                return (lo + self.bounds[i]) / 2.0
        return self.bounds[-1]


class MetricsRegistry:
    """Named metrics with get-or-create registration and cheap snapshots.

    The lock covers only the name->metric dicts; reading or writing a
    metric's value never takes it.  ``snapshot`` flattens everything to a
    ``Dict[str, float]`` (histograms contribute ``_count``/``_sum``/
    ``_p50``/``_p99`` keys) so scrapers and tests can diff two snapshots
    with plain dict ops.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(
        self, name: str, bounds: Optional[Sequence[float]] = None
    ) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(
                    name, Histogram(name, bounds or _DEFAULT_BOUNDS)
                )
        return h

    def snapshot(self) -> Dict[str, float]:
        """Flat point-in-time view.  Per-value reads are atomic; there is no
        consistent cut across metrics (see module docstring)."""
        out: Dict[str, float] = {}
        # iterate over list() copies so concurrent registration can't break
        # the loop; values are read without the lock by design
        for name, c in list(self._counters.items()):
            out[name] = c.get()
        for name, g in list(self._gauges.items()):
            out[name] = g.get()
        for name, h in list(self._histograms.items()):
            out[f"{name}_count"] = float(h.count)
            out[f"{name}_sum"] = h.sum
            out[f"{name}_p50"] = h.percentile(50)
            out[f"{name}_p99"] = h.percentile(99)
        return out

    def render_text(self) -> str:
        """Prometheus-style text exposition (one ``name value`` per line),
        served by ``launch/serve.py --metrics-port`` and printable from the
        bench.  Sorted for stable diffs."""
        snap = self.snapshot()
        return "".join(f"{k} {snap[k]:.9g}\n" for k in sorted(snap))
