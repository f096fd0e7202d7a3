"""Failure domains + deterministic fault injection (DESIGN.md §16).

ConServe's co-serving pitch only holds if offline harvesting can never take
the online path down.  This module is the vocabulary for that guarantee:

* **Typed failure domains.**  An exception escaping the engine loop is
  classified at the ``CoServingRuntime._step_once`` boundary into
  *request-scoped* (``RequestFailed`` — fail exactly one request, roll the
  scheduler back via the existing snapshot/restore machinery, keep serving
  everyone else) or *engine-fatal* (anything else — captured as an
  ``EngineDead`` that closes every stream with an error sentinel and makes
  ``submit``/``stream`` fail fast instead of queueing into a corpse).
* **Health states.**  ``RuntimeHealth`` is the runtime's published state
  machine: HEALTHY, DEGRADED (a recoverable fault or degradation was
  absorbed recently; still serving), FAILED (terminal; admission rejects).
* **Deterministic fault injection.**  ``FaultInjector`` arms *named fault
  points* threaded through the engine and block-manager hot paths.  Each
  point keeps an arm counter; a ``FaultSpec`` fires on an exact arm index,
  so a seeded schedule reproduces the same faults at the same iterations
  every run — tests and the wallclock bench assert recovery, token identity
  of surviving requests, and pool-invariant preservation instead of hoping.

Fault-point registry (the only names ``FaultSpec.point`` accepts):

========================  ====================================================
``dispatch``              armed once per executed engine iteration,
                          *pre-dispatch* (host-side cut: nothing has run yet,
                          so rollback is exact).  scope="request" raises
                          ``RequestFailed``; scope="engine" raises
                          ``InjectedFault`` (engine-fatal).
``dispatch.slow``         armed per iteration; stalls the engine thread via
                          the injector's ``sleep`` for ``delay_s`` (watchdog
                          fodder — deterministic under a ManualClock sleep).
``alloc.grow``            ``BlockManager.grow`` raises ``OutOfBlocks``
                          (device-pool exhaustion past the pre-check).
``alloc.resume``          ``BlockManager.resume`` raises ``OutOfBlocks``
                          (the scheduler defers the resume — degradation).
``cow.prepare``           ``BlockManager.prepare_write`` raises
                          ``OutOfBlocks`` (COW failure; victim hunt).
``host.checkpoint``       ``BlockManager.assign_checkpoint`` raises
                          ``OutOfBlocks`` (host pool pressure; the
                          checkpointer defers the rest of the round).
``host.swap_out``         ``BlockManager.preempt_swap_out`` raises
                          ``OutOfBlocks`` (swap falls back to discard).
========================  ====================================================

Every block-manager point is *caught by a degradation path* — an injected
``OutOfBlocks`` must never escape the engine loop; the fault-tolerance tests
assert exactly that.  The checks are plain host-side Python on objects, so
the fault-free path (``faults is None``) adds no traced programs and no
measurable overhead.
"""
from __future__ import annotations

import enum
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

FAULT_POINTS = (
    "dispatch",
    "dispatch.slow",
    "alloc.grow",
    "alloc.resume",
    "cow.prepare",
    "host.checkpoint",
    "host.swap_out",
)


class RuntimeHealth(enum.IntEnum):
    """Published health of the co-serving runtime (DESIGN.md §16).

    Integer values are the ``engine_health`` gauge encoding (0/1/2), chosen
    so dashboards can alert on ``engine_health > 0``.
    """

    HEALTHY = 0
    DEGRADED = 1  # absorbed a recoverable fault/degradation; still serving
    FAILED = 2  # terminal: engine-fatal exception or dead engine thread


class RequestFailed(RuntimeError):
    """Request-scoped failure domain: exactly one request is at fault.

    Raised inside the engine (today: by the fault injector's ``dispatch``
    point; the classification contract is that anything carrying a
    ``request_id`` attribution uses this type), caught at the runtime's
    ``_step_once`` boundary, which rolls the scheduler back, fails the one
    request (error-EOS on its ``TokenChannel``, typed error from
    ``StreamHandle.result``), frees its blocks, and keeps serving.
    """

    def __init__(self, request_id: int, reason: str):
        super().__init__(f"request {request_id} failed: {reason}")
        self.request_id = request_id
        self.reason = reason


class EngineDead(RuntimeError):
    """Engine-fatal failure domain: the engine loop cannot continue.

    Stored sticky on the runtime; every registered stream is closed with
    this as its error sentinel (waking blocked consumers), and subsequent
    ``submit``/``stream`` calls raise it immediately instead of queueing
    into a dead engine.  ``traceback_text`` carries the captured traceback
    of the original exception for the health endpoint / logs.
    """

    def __init__(self, message: str, traceback_text: Optional[str] = None):
        super().__init__(message)
        self.traceback_text = traceback_text


class RuntimeNotRunning(RuntimeError):
    """Typed error for submitting to a threaded runtime that was never
    started (or was stopped): previously such submissions queued silently
    into nothing.  Replay mode and ``manual=True`` runtimes are unaffected.
    """


class InjectedFault(RuntimeError):
    """An injected engine-fatal fault (scope="engine" ``dispatch`` specs).

    Deliberately NOT request-scoped: the runtime's generic classification
    treats it like any other unexpected engine exception, which is exactly
    what the engine-fatal tests exercise.
    """


@dataclass
class FaultSpec:
    """One scheduled fault: fire when ``point`` is armed for the ``at``-th
    time (0-based).  ``scope``/``request_id``/``delay_s`` only apply to the
    ``dispatch``/``dispatch.slow`` points (see the registry table)."""

    point: str
    at: int
    scope: str = "engine"  # "request" -> RequestFailed; "engine" -> fatal
    request_id: Optional[int] = None  # request scope: None = engine picks
    delay_s: float = 0.0  # dispatch.slow stall duration

    def __post_init__(self):
        if self.point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {self.point!r}; valid: {FAULT_POINTS}"
            )
        if self.scope not in ("engine", "request"):
            raise ValueError(f"unknown fault scope {self.scope!r}")
        if self.at < 0:
            raise ValueError("FaultSpec.at must be >= 0")


class FaultInjector:
    """Deterministic named-fault-point injector (DESIGN.md §16).

    Each call site arms its point (``arm``/``fires``); the injector counts
    arms per point and fires the spec scheduled at that exact index.  The
    schedule is data (a list of ``FaultSpec``), so a test or bench run is
    bit-reproducible: same schedule + same workload = same faults at the
    same iterations.  ``sleep`` is injectable so ``dispatch.slow`` stalls
    advance a ``ManualClock`` instead of real time in tests.
    """

    def __init__(
        self,
        specs: Sequence[FaultSpec] = (),
        sleep: Optional[Callable[[float], None]] = None,
    ):
        self._by_point: Dict[str, Dict[int, FaultSpec]] = {}
        for s in specs:
            slot = self._by_point.setdefault(s.point, {})
            if s.at in slot:
                raise ValueError(f"duplicate spec for {s.point!r} at {s.at}")
            slot[s.at] = s
        self.sleep = sleep or time.sleep
        self.counts: Dict[str, int] = {}
        self.injected = 0  # total faults fired (the bench metric)
        self.fired: List[Tuple[str, int]] = []  # (point, arm index) log

    @classmethod
    def seeded(
        cls,
        seed: int,
        plan: Mapping[str, Mapping[str, object]],
        sleep: Optional[Callable[[float], None]] = None,
    ) -> "FaultInjector":
        """Build a schedule from a seeded RNG: ``plan`` maps a fault point
        to ``{"n": count, "window": arm range, ...FaultSpec overrides}``;
        the ``n`` firing indices are drawn uniformly (without replacement)
        from ``range(window)``.  Same seed + plan = same schedule."""
        rng = random.Random(seed)
        specs: List[FaultSpec] = []
        for point in sorted(plan):
            opts = dict(plan[point])
            n = int(opts.pop("n", 1))
            window = int(opts.pop("window", 32))
            for at in sorted(rng.sample(range(window), min(n, window))):
                specs.append(FaultSpec(point=point, at=at, **opts))
        return cls(specs, sleep=sleep)

    def arm(self, point: str) -> Optional[FaultSpec]:
        """Count one arming of ``point``; return the spec to fire, if any."""
        i = self.counts.get(point, 0)
        self.counts[point] = i + 1
        spec = self._by_point.get(point, {}).get(i)
        if spec is not None:
            self.injected += 1
            self.fired.append((point, i))
        return spec

    def fires(self, point: str) -> bool:
        """``arm`` for boolean call sites (the block-manager points)."""
        return self.arm(point) is not None

    @property
    def pending(self) -> int:
        """Scheduled faults that have not fired yet."""
        total = sum(len(v) for v in self._by_point.values())
        return total - self.injected
