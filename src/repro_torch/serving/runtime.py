"""Wall-clock co-serving runtime: the unified scheduler driving RealEngine
under real time (DESIGN.md §10), with the serving-gateway surface on top
(DESIGN.md §15): per-request token streaming, bounded admission with typed
backpressure, and a lock-light metrics registry.

This is the loop that turns the policy stack into a *server*: each iteration
it drains API-thread arrivals, lets ``UnifiedScheduler.plan_iteration`` build
an ``IterationPlan`` against the wall clock, executes the plan on
``RealEngine``'s paged backend (prefill chunks, bucketed decode,
checkpoint/resume copies), and commits sampled tokens back.  The same drain
hook is installed as the engine's ``arrival_poll``, so it also runs between
K-layer segment dispatches of a pure-offline batch — an online request that
lands on the API thread mid-batch is seen at the next *real* safepoint,
Algorithm 2 runs there, and the batch aborts if TTFT is endangered.

Pipelined engines (``RealEngineConfig.pipeline``, DESIGN.md §13) need no
special-casing here: every delivery path goes through the engine's own
``submit`` / ``on_online_arrival``, which bump its plan generation, so a
speculatively staged batch is discarded and replanned at the next step —
the drain hooks cooperate with speculation for free.  The runtime's only
extra duty is ``_flush_engine`` at replay end / ``stop``, which drains the
engine's asynchronous artifacts (pending sampled-token readbacks and
checkpoint copies) so metrics and emitted tokens are complete.

Gateway surface (DESIGN.md §15):

* **Streaming** — ``register_stream(req)`` hands out a ``TokenChannel``
  the engine thread feeds after each iteration (``_pump_streams``), pushing
  only *materialized* token values (``Request.output_tokens``), never the
  structural count a pipelined engine runs ahead with.  A channel closes
  only when its request is finished AND every token value has been pushed,
  so iteration is lossless; ``stop``/``replay`` end always closes every
  channel so consumers cannot deadlock.
* **Backpressure** — ``submit`` runs against a per-class bounded ingress
  queue (``ServingConfig``): ``reject-fast`` raises ``QueueFull`` (429)
  with zero scheduler/KV state allocated; ``queue-with-timeout`` blocks the
  caller through the injected sleep up to a deadline, then raises
  ``QueueTimeout`` (503).  Online and offline budgets are separate, so an
  offline flood can never starve online admission.  The measured depth is
  undelivered ingress plus the scheduler's *waiting* queues as last
  published by the engine thread — exact when the engine is idle, at most
  one drain batch stale while it runs.
* **Metrics** — ``_publish_metrics`` refreshes a ``MetricsRegistry`` every
  iteration on the engine thread (queue depths, abort counts, per-class
  token throughput, SLO attainment via the incremental ``SLOTracker``,
  pool occupancy, prefix-cache hit rate, calibration drift, pipeline host
  gap).  Snapshots never block the engine.

Two ways to feed it:

* ``replay(trace)`` — single-threaded trace replay: requests carry
  ``arrival_time`` offsets (e.g. from ``serving.loadgen``); the loop delivers
  each once the wall clock passes its offset and returns ``ServiceMetrics``.
  This is what ``benchmarks/coserve_wallclock_bench.py`` runs.
* ``start()`` / ``stop()`` — background engine thread; any other thread
  (the API) calls ``submit`` / ``on_online_arrival``, which a ``Frontend``
  bound to the runtime does.  Ingress is a lock-protected queue: scheduler
  state is mutated only on the engine thread, at loop-top or safepoint
  drains, so the scheduler itself needs no locking.

Admission control runs synchronously on the submitting thread
(``UnifiedScheduler.check_admission`` is a pure read): an oversized request
raises ``AdmissionError`` to the API caller before it is ever queued.

Clocks: the runtime rebases the engine clock to seconds-since-start so
request timestamps (TTFT/TPOT) align with trace ``arrival_time`` offsets.
Tests inject a ``ManualClock``; production uses ``time.perf_counter``.
Every wait in the runtime — idle backoff, backpressure polling, the
``stop`` drain wait, the ``start`` loop's idle sleep — goes through the
injected ``self._sleep``, so a ``ManualClock``-driven runtime never
busy-waits real time.
"""
from __future__ import annotations

import threading
import time
import traceback
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.faults import (
    EngineDead,
    RequestFailed,
    RuntimeHealth,
    RuntimeNotRunning,
)
from repro_torch.core.request import Phase, Request
from repro_torch.core.scheduler import AdmissionError
from repro_torch.core.slo import ServiceMetrics, SLOTracker, summarize
from repro_torch.serving.api import EngineStalled, QueueFull, QueueTimeout, TokenChannel
from repro_torch.serving.metrics import MetricsRegistry


class ManualClock:
    """Deterministic clock for tests: advances only via ``advance``/``sleep``
    (plus an optional fixed ``auto_tick`` per reading, emulating compute
    time passing between observations)."""

    def __init__(self, t0: float = 0.0, auto_tick: float = 0.0):
        self.t = t0
        self.auto_tick = auto_tick

    def __call__(self) -> float:
        t = self.t
        self.t += self.auto_tick
        return t

    def advance(self, dt: float) -> None:
        self.t += dt

    def sleep(self, dt: float) -> None:  # duck-types time.sleep
        self.t += max(0.0, dt)


@dataclass
class ServingConfig:
    """Bounded-ingress gateway policy (DESIGN.md §15).

    ``max_queued_*`` bound *waiting* work per priority class: undelivered
    ingress plus the scheduler's waiting queue.  Running/preempted requests
    hold device or host KV and are not counted — the bound exists to stop
    unbounded queue growth, not to cap concurrency (the scheduler's token
    budget does that).  Separate class budgets mean offline floods shed
    offline load while online admission stays open (paper §4: harvesting
    must never tax the online tier).
    """

    max_queued_online: int = 64
    max_queued_offline: int = 256
    policy: str = "queue-with-timeout"  # or "reject-fast"
    queue_timeout_s: float = 2.0  # 503 deadline (queue-with-timeout)
    backpressure_poll_s: float = 0.002  # capacity re-check cadence
    # ---- health / watchdog (DESIGN.md §16) --------------------------------
    # admission rejects with EngineStalled (503) when the engine-thread
    # heartbeat is older than this while work is pending
    watchdog_timeout_s: float = 10.0
    # consecutive fault-free iterations before DEGRADED heals to HEALTHY
    health_recovery_iters: int = 20

    def __post_init__(self):
        if self.policy not in ("queue-with-timeout", "reject-fast"):
            raise ValueError(f"unknown backpressure policy: {self.policy!r}")


@dataclass
class RuntimeStats:
    arrivals_delivered: int = 0
    rejected: int = 0  # replayed-trace requests failing admission
    safepoint_aborts: int = 0
    # flag-set -> abort-observed latency per safepoint abort (Alg. 2
    # responsiveness, the real-execution twin of SimEngine's list)
    preemption_latencies: List[float] = field(default_factory=list)
    # replay() hit max_steps with work remaining — metrics are partial
    steps_exhausted: bool = False
    # failure domains (DESIGN.md §16)
    requests_failed: int = 0  # request-scoped faults absorbed
    degraded_transitions: int = 0  # HEALTHY -> DEGRADED edges


class CoServingRuntime:
    """Drive a ``RealEngine`` with wall-clock arrivals (see module docstring).

    ``engine`` must expose the RealEngine surface: ``step()``, ``steps``,
    ``sched``, ``flag``, ``safepoints``, ``arrival_poll``, ``set_clock``.
    """

    def __init__(
        self,
        engine,
        clock: Optional[Callable[[], float]] = None,
        sleep: Optional[Callable[[float], None]] = None,
        idle_backoff_s: float = 0.0005,
        serving: Optional[ServingConfig] = None,
        registry: Optional[MetricsRegistry] = None,
        manual: bool = False,
    ):
        self.engine = engine
        # manual=True: the caller drives engine.step() itself (tests,
        # single-threaded harnesses) — submissions are accepted without a
        # running engine thread instead of raising RuntimeNotRunning
        self.manual = manual
        self._clock = clock or time.perf_counter
        self._sleep = sleep or (
            clock.sleep if isinstance(clock, ManualClock) else time.sleep
        )
        self.idle_backoff_s = idle_backoff_s
        self.serving = serving or ServingConfig()
        self.registry = registry or MetricsRegistry()
        self.stats = RuntimeStats()
        self._t0 = self._clock()
        self._lock = threading.Lock()
        self._pending: List[Request] = []
        self._trace: List[Request] = []  # sorted by arrival_time, replay mode
        self._trace_pos = 0
        self._abort_trigger_t: Optional[float] = None
        self._aborts_seen = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.duration = 0.0
        # scheduler waiting/running/preempted depths as last published by
        # the engine thread (under _lock) — API threads read these instead
        # of touching scheduler lists cross-thread
        self._sched_depths: Tuple[int, int, int, int] = (0, 0, 0, 0)
        # request_id -> [request, channel, tokens_fed]; the fed count is
        # mutated on the engine thread only
        self._streams: Dict[int, list] = {}
        self._slo_tracker = SLOTracker(engine.sched.slo)
        self._prompt_tokens_delivered = 0
        # ---- failure domains / health (DESIGN.md §16) -------------------
        self._health = RuntimeHealth.HEALTHY
        self._fatal: Optional[EngineDead] = None  # sticky engine-fatal error
        self._heartbeat = self._clock()  # engine-thread liveness timestamp
        self._degraded_seen = 0  # high-water mark of absorbed degradations
        self._clean_steps = 0  # fault-free iterations since last degradation
        self._replay_active = False
        self.failed: List[Request] = []  # request-scoped casualties
        engine.set_clock(self.now)
        engine.arrival_poll = self._drain_arrivals

    @property
    def sched(self):
        """The engine's ``UnifiedScheduler`` (lets a ``Frontend`` bound to
        the runtime reach admission checks and metrics uniformly)."""
        return self.engine.sched

    # ---------------------------------------------------------------- clock
    def now(self) -> float:
        """Seconds since the runtime was created (or since ``replay`` began)."""
        return self._clock() - self._t0

    # ----------------------------------------------- health / watchdog (§16)
    @property
    def health(self) -> RuntimeHealth:
        return self._health

    def check_health(self) -> Tuple[RuntimeHealth, float]:
        """(health, heartbeat age in seconds) — the ``/health`` endpoint
        surface.  Safe from any thread; also detects an engine thread that
        died without reporting (the belt-and-braces case — a raised
        exception is always classified by ``_step_once`` first)."""
        if (
            self._fatal is None
            and self._thread is not None
            and not self._thread.is_alive()
            and not self._stop.is_set()
        ):
            self._note_thread_death()
        return self._health, max(0.0, self._clock() - self._heartbeat)

    def _set_health(self, h: RuntimeHealth) -> None:
        """Engine-thread health transitions.  FAILED is terminal; the
        HEALTHY -> DEGRADED edge is counted (``degraded_transitions``)."""
        if self._health == RuntimeHealth.FAILED or h == self._health:
            return
        if h == RuntimeHealth.DEGRADED:
            self.stats.degraded_transitions += 1
            self._clean_steps = 0
        self._health = h

    def _note_degradation(self) -> None:
        """Fold absorbed degradations (scheduler pool-pressure fallbacks,
        checkpoint skips, failed requests) into the health state: any new
        one flips DEGRADED; ``health_recovery_iters`` consecutive clean
        iterations heal back to HEALTHY."""
        total = self.stats.requests_failed
        total += sum(getattr(self.engine.sched, "degraded", {}).values())
        ckpt = getattr(self.engine, "ckpt", None)
        if ckpt is not None:
            total += ckpt.stats.host_pool_skips
        if total > self._degraded_seen:
            self._degraded_seen = total
            self._set_health(RuntimeHealth.DEGRADED)
        elif self._health == RuntimeHealth.DEGRADED:
            self._clean_steps += 1
            if self._clean_steps >= self.serving.health_recovery_iters:
                self._set_health(RuntimeHealth.HEALTHY)

    def _note_thread_death(self) -> None:
        """The engine thread is gone without a classified exception (e.g.
        killed externally): synthesize the engine-fatal state so streams
        wake and submissions fail fast instead of queueing forever."""
        err = EngineDead("engine thread died without reporting an error")
        self._fatal = err
        self._health = RuntimeHealth.FAILED
        self._close_all_streams(error=err)

    def _check_accepting(self) -> None:
        """Fail-fast gate for submissions (after the pure admission check,
        so oversized requests keep raising ``AdmissionError`` first).

        Raises ``EngineDead`` when the engine is dead, ``RuntimeNotRunning``
        when the threaded runtime was never started (or is stopping), and
        ``EngineStalled`` (503) when the watchdog sees a stale heartbeat
        with work pending.  ``manual=True`` runtimes and replay mode skip
        the thread checks — their caller drives the engine directly.
        DEGRADED does NOT reject: graceful degradation keeps serving."""
        if self._fatal is not None:
            raise self._fatal
        if self.manual or self._replay_active:
            return
        if self._thread is None:
            raise RuntimeNotRunning(
                "runtime not started: call start() first (or construct "
                "with manual=True to drive engine.step() yourself)"
            )
        if not self._thread.is_alive():
            self._note_thread_death()
            raise self._fatal
        if self._stop.is_set():
            raise RuntimeNotRunning("runtime is stopping")
        with self._lock:
            busy = bool(self._pending) or any(self._sched_depths)
        age = self._clock() - self._heartbeat
        if busy and age > self.serving.watchdog_timeout_s:
            raise EngineStalled(
                f"engine heartbeat is {age:.3f}s old with work pending "
                f"(watchdog_timeout_s={self.serving.watchdog_timeout_s})"
            )

    # -------------------------------------------------------------- ingress
    def submit(self, req: Request) -> None:
        """Thread-safe submission (either priority class) with bounded
        ingress.

        Admission is validated *synchronously* on the calling thread —
        ``AdmissionError`` propagates to the API caller before the request
        is queued, and no device state exists for it.  A full per-class
        queue then raises ``QueueFull`` (reject-fast) or blocks to the
        configured deadline before raising ``QueueTimeout``
        (queue-with-timeout); both leave zero state behind.
        """
        self.engine.sched.check_admission(req)
        self._check_accepting()
        self._admit_bounded([req])

    def submit_all(self, reqs: Sequence[Request]) -> None:
        """All-or-nothing submission: admission-check every request, then
        reserve ingress capacity for the whole pool atomically — a
        ``QueueFull``/``QueueTimeout`` rejection queues none of them
        (``Frontend.submit_batch`` binds to this)."""
        for r in reqs:
            self.engine.sched.check_admission(r)
        self._check_accepting()
        self._admit_bounded(list(reqs))

    def on_online_arrival(self, req: Request) -> None:
        """Streaming-API entry (``Frontend`` binds to this).  The urgent
        Algorithm 2 decision runs on the engine thread at the next drain
        point — loop-top or a safepoint inside an in-flight batch."""
        self.submit(req)

    def _queue_depths_locked(self) -> Tuple[int, int]:
        """(online, offline) waiting depth; caller holds ``_lock``."""
        pend_on = sum(1 for r in self._pending if r.is_online)
        return (
            pend_on + self._sched_depths[0],
            (len(self._pending) - pend_on) + self._sched_depths[1],
        )

    def _admit_bounded(self, reqs: List[Request]) -> None:
        cfg = self.serving
        want_on = sum(1 for r in reqs if r.is_online)
        want_off = len(reqs) - want_on
        t_entry = self.now()  # queue wait counts against TTFT
        deadline = self._clock() + cfg.queue_timeout_s
        cls = "online" if want_on else "offline"
        while True:
            with self._lock:
                depth_on, depth_off = self._queue_depths_locked()
                if (
                    depth_on + want_on <= cfg.max_queued_online
                    and depth_off + want_off <= cfg.max_queued_offline
                ):
                    for r in reqs:
                        if r.arrival_time == 0.0:
                            r.arrival_time = t_entry
                        self._pending.append(r)
                    # ingress counters: multiple API threads write these, so
                    # they are serialized by the ingress lock (the registry
                    # itself is lock-free on the value path)
                    if want_on:
                        self.registry.counter(
                            "ingress_submitted_total_online"
                        ).inc(want_on)
                    if want_off:
                        self.registry.counter(
                            "ingress_submitted_total_offline"
                        ).inc(want_off)
                    return
            if cfg.policy == "reject-fast":
                with self._lock:
                    self.registry.counter(
                        f"ingress_queue_full_total_{cls}"
                    ).inc()
                raise QueueFull(
                    f"{cls} ingress queue full "
                    f"(online {depth_on}/{cfg.max_queued_online}, "
                    f"offline {depth_off}/{cfg.max_queued_offline})"
                )
            if self._clock() >= deadline:
                with self._lock:
                    self.registry.counter(
                        f"ingress_queue_timeout_total_{cls}"
                    ).inc()
                raise QueueTimeout(
                    f"{cls} ingress capacity did not free within "
                    f"{cfg.queue_timeout_s:.3f}s "
                    f"(online {depth_on}/{cfg.max_queued_online}, "
                    f"offline {depth_off}/{cfg.max_queued_offline})"
                )
            self._sleep(cfg.backpressure_poll_s)

    # ------------------------------------------------------------ streaming
    def register_stream(self, req: Request) -> TokenChannel:
        """Create the per-request token channel (``Frontend.stream`` calls
        this *before* submitting, so no committed token can race past it)."""
        ch = TokenChannel()
        with self._lock:
            self._streams[req.request_id] = [req, ch, 0]
        return ch

    def unregister_stream(self, req: Request) -> None:
        with self._lock:
            self._streams.pop(req.request_id, None)

    def _pump_streams(self) -> None:
        """Engine thread (and shutdown paths): push newly *materialized*
        token values to each registered channel, closing channels whose
        request is finished with every value pushed.

        Feeds from ``Request.output_tokens`` only — a pipelined engine's
        structural commits (``num_generated``) can run ahead of token-value
        readbacks, and the lossless contract is about values.  End-of-stream
        therefore requires ``fed == num_generated == len(output_tokens)``,
        which ``_flush_engine`` guarantees is reachable at shutdown.
        """
        with self._lock:
            entries = list(self._streams.values())
        done_ids = []
        for entry in entries:
            req, ch, fed = entry
            toks = req.output_tokens
            n = len(toks)
            if n > fed:
                ch.push(toks[fed:n])
                entry[2] = fed = n
            if (
                req.phase == Phase.FINISHED
                and fed == req.num_generated == len(req.output_tokens)
            ):
                ch.close()
                done_ids.append(req.request_id)
        if done_ids:
            with self._lock:
                for rid in done_ids:
                    self._streams.pop(rid, None)

    def _close_all_streams(self, error: Optional[BaseException] = None) -> None:
        """Shutdown backstop: close every remaining channel (even for
        unfinished requests) so blocked consumers always wake up.  With
        ``error`` (engine-fatal shutdown), each channel carries the error
        sentinel — consumers drain their delivered prefix, then see the
        typed failure instead of a silent early end-of-stream."""
        with self._lock:
            entries = list(self._streams.values())
            self._streams.clear()
        for _req, ch, _fed in entries:
            ch.close(error=error)

    # ---------------------------------------------------------------- drain
    def _drain_arrivals(self) -> None:
        """Deliver due arrivals into the scheduler.  Engine thread only:
        runs at loop-top each iteration and at every safepoint between
        K-layer segment dispatches (``engine.arrival_poll``)."""
        now = self.now()
        due: List[Request] = []
        while (
            self._trace_pos < len(self._trace)
            and self._trace[self._trace_pos].arrival_time <= now
        ):
            due.append(self._trace[self._trace_pos])
            self._trace_pos += 1
        with self._lock:
            if self._pending:
                due.extend(self._pending)
                self._pending.clear()
        for r in due:
            try:
                if r.is_online:
                    was_set = self.engine.flag.is_set()
                    self.engine.on_online_arrival(r)
                    if self.engine.flag.is_set() and not was_set:
                        self._abort_trigger_t = now
                else:
                    self.engine.submit(r)
            except AdmissionError:
                # replayed traces may contain oversized requests; direct
                # submitters got the error synchronously in submit()
                self.stats.rejected += 1
                self.registry.counter("ingress_admission_rejected_total").inc()
                continue
            self.stats.arrivals_delivered += 1
            self._prompt_tokens_delivered += r.prompt_len
        if due:
            # republish scheduler depths at delivery time, not just after the
            # step: stop(drain)'s wait must see this work as busy even while
            # the (possibly long) iteration that admits it is still running
            depths = self.engine.sched.queue_depths()
            with self._lock:
                self._sched_depths = depths

    def _flush_engine(self) -> None:
        """Drain the engine's asynchronous pipeline artifacts (pending
        sampled-token fetches, in-flight checkpoint copies) before metrics
        are read.  No-op for engines without a pipeline (§13)."""
        flush = getattr(self.engine, "flush_pipeline", None)
        if flush is not None:
            flush()

    def _observe_aborts(self) -> None:
        """Track Algorithm 2 responsiveness.

        The trigger timestamp is set when a drained online arrival flips the
        preemption flag.  It must survive steps in which no abort lands yet:
        a flag set at a late safepoint (or at loop-top of a non-preemptible
        iteration) is consumed only at a *later* boundary, and clearing the
        trigger unconditionally would record no latency for that abort.  So
        the trigger is cleared only (a) when the matching abort is observed
        (latency recorded), or (b) when the engine consumed the flag without
        aborting — e.g. the online request was admitted into the next plan
        normally — in which case no abort will ever match it.
        """
        aborts = self.engine.safepoints.stats.preemptions
        if aborts > self._aborts_seen:
            self.stats.safepoint_aborts += aborts - self._aborts_seen
            self._aborts_seen = aborts
            if self._abort_trigger_t is not None:
                self.stats.preemption_latencies.append(
                    self.now() - self._abort_trigger_t
                )
                self._abort_trigger_t = None
        elif self._abort_trigger_t is not None and not self.engine.flag.is_set():
            self._abort_trigger_t = None

    # -------------------------------------------------------------- metrics
    def _publish_metrics(self) -> None:
        """Refresh the registry from engine/scheduler state.  Engine thread
        (plus the shutdown paths, after the engine thread has exited) — all
        value writes are single-writer, so the registry needs no locks."""
        eng = self.engine
        sched = eng.sched
        reg = self.registry
        depths = sched.queue_depths()
        with self._lock:
            self._sched_depths = depths
        reg.gauge("queue_depth_online").set(depths[0])
        reg.gauge("queue_depth_offline").set(depths[1])
        reg.gauge("running_seqs").set(depths[2])
        reg.gauge("preempted_seqs").set(depths[3])
        reg.counter("iterations_total").set_to(eng.steps)
        sp = eng.safepoints.stats
        reg.counter("aborted_iterations_total").set_to(sp.preemptions)
        reg.counter("safepoint_checks_total").set_to(sp.checks)
        # per-class token totals (monotone envelopes: a preemption resets a
        # request's num_prefilled, so raw processed sums can dip; set_to
        # keeps the counter at the high-water mark)
        gen_on = gen_off = proc_on = proc_off = 0
        requests = sched.all_requests()
        for r in requests:
            proc = min(r.num_prefilled, r.prompt_len) + r.num_generated
            if r.is_online:
                gen_on += r.num_generated
                proc_on += proc
            else:
                gen_off += r.num_generated
                proc_off += proc
        reg.counter("tokens_generated_total_online").set_to(gen_on)
        reg.counter("tokens_generated_total_offline").set_to(gen_off)
        reg.counter("tokens_processed_total_online").set_to(proc_on)
        reg.counter("tokens_processed_total_offline").set_to(proc_off)
        # SLO attainment, incremental and identical to summarize()'s values
        new_ttfts, new_tpots = self._slo_tracker.observe(requests)
        if new_ttfts:
            h = reg.histogram("ttft_seconds")
            for t in new_ttfts:
                h.observe(t)
        if new_tpots:
            h = reg.histogram("tpot_seconds")
            for t in new_tpots:
                h.observe(t)
        reg.gauge("slo_ttft_attainment").set(self._slo_tracker.ttft_attainment)
        reg.gauge("slo_tpot_attainment").set(self._slo_tracker.tpot_attainment)
        # KV pool + prefix cache
        blocks = sched.blocks
        reg.gauge("pool_occupancy").set(blocks.device_utilization)
        reg.gauge("pool_cached_free_blocks").set(blocks.cached_free_blocks)
        saved = getattr(blocks, "prefix_tokens_saved", 0)
        reg.counter("prefix_tokens_saved_total").set_to(saved)
        reg.gauge("prefix_cache_hit_rate").set(
            saved / max(1, self._prompt_tokens_delivered)
        )
        # calibration drift: measured wall time per iteration vs what the
        # installed latency model predicted for the same shapes (pipelined
        # engines report enqueue-side time, so drift < 1 is expected there)
        measured = getattr(eng, "measured_iter_seconds", 0.0)
        predicted = getattr(eng, "predicted_iter_seconds", 0.0)
        reg.counter("iter_measured_seconds_total").set_to(measured)
        reg.counter("iter_predicted_seconds_total").set_to(predicted)
        if predicted > 0.0:
            reg.gauge("calibration_drift").set(measured / predicted)
        # async pipeline (§13)
        reg.counter("host_gap_seconds_total").set_to(
            getattr(eng, "host_gap_seconds", 0.0)
        )
        reg.counter("host_gap_count_total").set_to(
            getattr(eng, "host_gap_count", 0)
        )
        reg.counter("pipeline_discards_total").set_to(
            getattr(eng, "pipeline_discards", 0)
        )
        # failure domains / health / fault injection (§16)
        reg.gauge("engine_health").set(int(self._health))
        reg.gauge("engine_heartbeat_age_seconds").set(
            max(0.0, self._clock() - self._heartbeat)
        )
        reg.counter("requests_failed_total").set_to(self.stats.requests_failed)
        reg.counter("degraded_transitions_total").set_to(
            self.stats.degraded_transitions
        )
        for k, v in getattr(sched, "degraded", {}).items():
            reg.counter(f"degraded_{k}_total").set_to(v)
        ckpt = getattr(eng, "ckpt", None)
        if ckpt is not None:
            reg.counter("degraded_ckpt_skipped_total").set_to(
                ckpt.stats.host_pool_skips
            )
        faults = getattr(eng, "faults", None)
        if faults is not None:
            reg.counter("faults_injected_total").set_to(faults.injected)

    # ----------------------------------------------------------------- loop
    def _step_once(self) -> bool:
        """One engine iteration with arrival delivery; returns False when
        the engine reports no remaining work OR died.

        This is the failure-domain boundary (DESIGN.md §16): a
        ``RequestFailed`` escaping the engine fails exactly one request
        (scheduler rolled back, blocks freed, error-EOS on its stream) and
        the loop keeps serving; any other exception is engine-fatal — the
        traceback is captured into a sticky ``EngineDead``, health flips to
        FAILED, every stream consumer wakes with the error sentinel, and
        subsequent submissions fail fast."""
        self._heartbeat = self._clock()
        try:
            return self._step_guarded()
        except RequestFailed as rf:
            self._recover_request_fault(rf)
            return True
        except Exception as exc:
            self._engine_fatal(exc)
            return False

    def _step_guarded(self) -> bool:
        self._drain_arrivals()
        before = self.engine.steps
        alive = self.engine.step()
        self._note_degradation()
        self._observe_aborts()
        self._pump_streams()
        self._publish_metrics()
        if alive and self.engine.steps == before:
            # work exists but nothing was schedulable (e.g. memory wedged
            # behind a pending resume): back off instead of spinning
            self._sleep(self.idle_backoff_s)
        return alive

    def _recover_request_fault(self, rf: RequestFailed) -> None:
        """Request-scoped recovery: roll the engine back to the
        pre-iteration cut (nothing of the failed iteration dispatched —
        faults fire pre-execution), excise the one failed request from
        every engine structure, surface the typed error on its stream, and
        keep serving.  Surviving requests are untouched, so their tokens
        stay bitwise identical to a fault-free run."""
        eng = self.engine
        eng.recover_from_fault()
        victim = None
        for r in eng.sched.all_requests():
            if r.request_id == rf.request_id:
                victim = r
                break
        self.stats.requests_failed += 1
        if victim is not None and victim.phase != Phase.FINISHED:
            eng.fail_request(victim)
            victim.phase = Phase.FAILED
            victim.error = rf
            victim.finish_time = self.now()
            self.failed.append(victim)
        # flush the victim's pre-fault delivered tokens (lossless prefix),
        # then error-EOS its channel; other streams just keep flowing
        self._pump_streams()
        with self._lock:
            entry = self._streams.pop(rf.request_id, None)
        if entry is not None:
            entry[1].close(error=rf)
        self._set_health(RuntimeHealth.DEGRADED)
        self._publish_metrics()

    def _engine_fatal(self, exc: BaseException) -> None:
        """Engine-fatal path: capture the traceback, flip health to FAILED
        (terminal), stop the loop, and wake every blocked stream consumer
        with the sticky ``EngineDead`` sentinel."""
        err = EngineDead(
            f"engine loop died: {exc!r}", traceback_text=traceback.format_exc()
        )
        err.__cause__ = exc
        self._fatal = err
        self._health = RuntimeHealth.FAILED  # bypass _set_health: terminal
        self._stop.set()
        try:
            self._pump_streams()  # best effort: committed values first
        except Exception:
            pass
        self._close_all_streams(error=err)
        try:
            self._publish_metrics()
        except Exception:
            pass

    def replay(
        self,
        trace: Sequence[Request],
        duration: Optional[float] = None,
        drain: bool = True,
        max_steps: int = 1_000_000,
    ) -> ServiceMetrics:
        """Replay a timed trace to completion and return ``ServiceMetrics``.

        ``trace`` requests carry ``arrival_time`` offsets relative to replay
        start; the loop sleeps through genuinely idle gaps.  With ``drain``
        (default) requests in flight at ``duration`` run to completion —
        pass ``drain=False`` to cut off at ``duration`` sharp.

        If ``max_steps`` elapses with work remaining the partial return is
        made loud: ``stats.steps_exhausted`` is set and a ``RuntimeWarning``
        is emitted (metrics over an unfinished replay understate latency).
        """
        if self._fatal is not None:
            raise self._fatal
        self._trace = sorted(trace, key=lambda r: r.arrival_time)
        self._trace_pos = 0
        self._t0 = self._clock()
        self.stats.steps_exhausted = False
        self._replay_active = True
        try:
            for _ in range(max_steps):
                now = self.now()
                if duration is not None and now >= duration and not drain:
                    break
                alive = self._step_once()
                if self._fatal is not None:
                    # engine-fatal mid-replay: streams are already closed
                    # with the sentinel; surface the typed error below
                    break
                if not alive:
                    with self._lock:
                        if self._pending:
                            continue
                    if self._trace_pos < len(self._trace):
                        # idle until the next trace arrival
                        gap = self._trace[self._trace_pos].arrival_time - self.now()
                        if gap > 0:
                            self._sleep(gap)
                        continue
                    break
            else:
                self.stats.steps_exhausted = True
                warnings.warn(
                    f"replay exhausted max_steps={max_steps} with work remaining; "
                    "returned metrics cover a partial replay",
                    RuntimeWarning,
                    stacklevel=2,
                )
        finally:
            self._replay_active = False
        if self._fatal is None:
            self._flush_engine()
            self._pump_streams()
        self._close_all_streams(error=self._fatal)
        self.duration = self.now()
        try:
            self._publish_metrics()
        except Exception:
            if self._fatal is None:
                raise
        if self._fatal is not None:
            raise self._fatal
        return self.metrics()

    # -------------------------------------------------------- threaded mode
    def start(self) -> None:
        """Run the engine loop on a background thread; submit from any
        thread via ``submit`` / ``on_online_arrival`` (or a ``Frontend``
        bound to this runtime)."""
        if self._fatal is not None:
            raise self._fatal  # a dead engine does not restart
        if self._thread is not None:
            raise RuntimeError("runtime already started")
        self._stop.clear()
        self._t0 = self._clock()
        self._heartbeat = self._clock()

        def loop():
            while not self._stop.is_set():
                if not self._step_once():
                    # nothing to do: wait for arrivals without burning CPU
                    # (through the injected sleep — a ManualClock runtime
                    # must not busy-wait real time)
                    self._sleep(self.idle_backoff_s)

        self._thread = threading.Thread(
            target=loop, name="coserve-engine", daemon=True
        )
        self._thread.start()

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop the engine thread; with ``drain`` (default), first wait for
        all in-flight and queued work to finish.

        The drain check reads undelivered ingress plus the engine-published
        scheduler depth snapshot — never the scheduler's lists directly,
        which only the engine thread may touch.  All waiting goes through
        the injected clock/sleep.  Every registered stream channel is closed
        on the way out (lossless if drained; a cut-off stream still wakes
        its consumer).
        """
        if self._thread is None:
            return
        if drain:
            deadline = self._clock() + timeout
            while self._clock() < deadline:
                if self._fatal is not None or not self._thread.is_alive():
                    # dead/dying engine: nothing will ever drain — bail
                    # immediately instead of burning the full timeout
                    break
                with self._lock:
                    busy = bool(self._pending) or any(self._sched_depths)
                if not busy:
                    break
                self._sleep(self.idle_backoff_s)
        self._stop.set()
        self._thread.join(timeout=timeout)
        self._thread = None
        if self._fatal is None:
            self._flush_engine()
            self._pump_streams()
        self._close_all_streams(error=self._fatal)
        self.duration = self.now()
        try:
            self._publish_metrics()
        except Exception:
            if self._fatal is None:
                raise

    # -------------------------------------------------------------- metrics
    def metrics(self, duration: Optional[float] = None) -> ServiceMetrics:
        """Wall-clock ``ServiceMetrics`` over everything the engine has seen
        (the real-execution counterpart of ``SimEngine.metrics``)."""
        return summarize(
            self.engine.sched.all_requests(),
            self.engine.sched.slo,
            duration or self.duration or self.now(),
        )
