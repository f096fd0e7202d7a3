"""ConServe's unified preemptive scheduler (paper Algorithms 1 and 2).

One scheduler serves both priority classes:

* online requests are admitted first, within an SLO-derived token budget
  (``calc_budget``); their decode tokens are never preempted by offline work;
* offline requests harvest the residual budget ("SLOAwareSchedule(Q_off, τ)");
* when online load spikes, scheduled offline requests are preempted at
  scheduling time (``PreemptOverBudgetOffline`` — free if checkpointed), and
  a *running* pure-offline batch can be aborted mid-iteration at a layer
  safepoint (Algorithm 2, ``on_online_arrival``);
* with no online work anywhere, the scheduler switches to *offline batching
  mode*: budget is lifted to the saturation cap and safepoints are enabled.

The scheduler owns request state + the block manager; it does not touch
device memory — it returns an ``IterationPlan`` that the engine executes
(really, or in simulated time) and then ``commit``s back.  It is also the
admission-control point: ``submit`` rejects requests that can never fit
``max_model_len`` with a typed ``AdmissionError`` before any queueing or
block allocation (DESIGN.md §9).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.kvcache.block_manager import BlockManager, OutOfBlocks
from repro_torch.models.config import ModelConfig

from .budget import TokenBudget, calc_budget
from .profiler import (
    BatchShape,
    LatencyModel,
    decode_shape,
    prefill_chunk_shape,
)
from .request import Phase, Priority, Request
from .slo import SLO

# ---------------------------------------------------------------------------


class AdmissionError(ValueError):
    """Request rejected at admission time, before any device state exists.

    Raised by ``UnifiedScheduler.submit`` (and therefore by the engine/API
    submission paths) when a request can never fit the serving configuration
    — e.g. ``prompt_len + max_new_tokens`` exceeds ``max_model_len``.  The
    contract is that admission rejection happens *before* the request enters
    any queue and before a single KV block is allocated, so callers can
    surface a typed error to the client instead of a mid-run failure from
    the execution backend.
    """


@dataclass
class PrefillChunk:
    request: Request
    offset: int  # tokens already in device KV
    length: int  # tokens this iteration


@dataclass
class IterationPlan:
    prefill_chunks: List[PrefillChunk] = field(default_factory=list)
    decode_reqs: List[Request] = field(default_factory=list)
    shape: BatchShape = field(default_factory=BatchShape)
    budget: Optional[TokenBudget] = None
    pure_offline: bool = False  # safepoints enabled iff True (paper §4.3)
    preempted: List[Request] = field(default_factory=list)

    @property
    def empty(self) -> bool:
        return not self.prefill_chunks and not self.decode_reqs


@dataclass
class SchedulerSnapshot:
    """Rollback state for a speculatively planned iteration (see
    ``UnifiedScheduler.snapshot`` / ``restore``, DESIGN.md §13)."""

    online_q: List[Request]
    offline_q: List[Request]
    running: List[Request]
    preempted: List[Request]
    finished: List[Request]
    events: List[Tuple[str, Request, list]]
    t_sched: float
    current_plan: Optional[IterationPlan]
    blocks: tuple  # BlockManager.snapshot()
    known_ids: set  # id() of every request known at snapshot time
    # (request, phase, num_prefilled, num_preemptions, host_recoverable,
    #  first_scheduled_time, prefix_cached) — the plan-mutable Request fields
    req_state: List[tuple]
    # degradation counters (rolled back with the plan so speculative
    # planning never inflates them — DESIGN.md §16)
    degraded: dict = field(default_factory=dict)


@dataclass
class SchedulerConfig:
    chunk_size: int = 512  # chunked-prefill unit (paper adopts Sarathi-style)
    max_batch_seqs: int = 256
    # Offline batching mode is MEMORY-limited, not token-limited (§4.2:
    # "ignores the budget limit and sets the largest batch size that can
    # saturate GPU compute or memory capacity"); responsiveness comes from
    # safepoints.  Override with a finite cap to bound iteration length.
    offline_batch_tokens: int = 1 << 30
    budget_headroom: float = 0.8
    avg_ctx_estimate: int = 1024
    # ablation switches (benchmarks/fig8):
    slo_aware: bool = True  # False -> vLLM++-style: ignore budget, pack max
    preempt_running: bool = True  # Algorithm 2 urgent preemption
    swap_on_preempt: bool = False  # PREEMPTSCHEDULING: swap instead of discard
    # Admission control: requests with prompt_len + max_new_tokens beyond
    # this are rejected with AdmissionError at submit() time (None = no cap;
    # the real engine sets it to its KV capacity, RealEngineConfig.max_model_len).
    max_model_len: Optional[int] = None


class UnifiedScheduler:
    def __init__(
        self,
        cfg: ModelConfig,
        model: LatencyModel,
        slo: SLO,
        blocks: BlockManager,
        sched_cfg: SchedulerConfig = SchedulerConfig(),
        clock: Optional[Callable[[], float]] = None,
    ):
        self.cfg = cfg
        self.model = model
        self.slo = slo
        self.blocks = blocks
        self.sc = sched_cfg
        self.online_q: List[Request] = []
        self.offline_q: List[Request] = []
        self.running: List[Request] = []  # device-resident (prefill/decode)
        self.preempted: List[Request] = []  # offline, evicted, resumable
        self.finished: List[Request] = []
        self.t_sched: float = 0.0  # when the current batch was dispatched
        self.current_plan: Optional[IterationPlan] = None
        self.preempt_flag: bool = False  # shared with the worker (Alg. 2)
        self._clock = clock or (lambda: 0.0)
        # engine hooks ----------------------------------------------------
        # events: ("preempt_discard"|"preempt_swap"|"resume"|"cow", req,
        # payload) — payload is the block-manager copy/free list for the
        # transition (len == number of blocks moved); the real engine uses
        # the physical ids, the sim engine only accounts the bytes.  "cow"
        # carries (block_index, src, dst) copy-on-write triples the engine
        # must realize on device before the iteration's KV writes (§14).
        self.events: List[Tuple[str, Request, list]] = []
        # gate for background swap-in admission (None = always allow)
        self.io_gate: Optional[Callable[[], bool]] = None
        # graceful-degradation counters (DESIGN.md §16): pool-pressure
        # events absorbed without raising into the engine loop.  Published
        # as degraded_*_total metrics by the wall-clock runtime; captured
        # in snapshots so speculative rollbacks don't inflate them.
        self.degraded: Dict[str, int] = {
            "resume_deferred": 0,  # OutOfBlocks on resume -> stay preempted
            "swap_fallback": 0,  # host pool full on swap-out -> discard
            "alloc_retry": 0,  # grow failed past pre-check -> victim hunt
            "cow_retry": 0,  # COW copies failed -> victim hunt
        }

    # ------------------------------------------------------------ submission
    def check_admission(self, req: Request) -> None:
        """Validate a request against the serving configuration.

        Pure read — safe to call from any thread (the wall-clock runtime's
        API ingress validates synchronously, before queuing the request for
        the engine thread).  Raises ``AdmissionError``; allocates nothing.
        """
        cap = self.sc.max_model_len
        if cap is not None and req.target_len > cap:
            raise AdmissionError(
                f"request {req.request_id}: prompt_len ({req.prompt_len}) + "
                f"max_new_tokens ({req.max_new_tokens}) = {req.target_len} "
                f"exceeds max_model_len ({cap})"
            )

    def submit(self, req: Request) -> None:
        self.check_admission(req)
        (self.online_q if req.is_online else self.offline_q).append(req)

    @property
    def has_online_work(self) -> bool:
        return (
            bool(self.online_q)
            or any(
                r.is_online for r in self.running if r.phase != Phase.FINISHED
            )
            or any(r.is_online for r in self.preempted)
        )

    def queue_depths(self) -> Tuple[int, int, int, int]:
        """(online_waiting, offline_waiting, running, preempted) list lengths.

        Four ``len`` reads of lists mutated only on the engine thread; the
        wall-clock runtime publishes the result under its ingress lock each
        iteration so API threads (backpressure checks, ``stop`` drain waits,
        metrics gauges) never touch scheduler lists directly (DESIGN.md §15).
        """
        return (
            len(self.online_q),
            len(self.offline_q),
            len(self.running),
            len(self.preempted),
        )

    def all_requests(self) -> List[Request]:
        return (
            self.online_q
            + self.offline_q
            + self.running
            + self.preempted
            + self.finished
        )

    # ---------------------------------------------------------------- memory
    def _bytes_per_block(self) -> int:
        from .profiler import block_bytes

        return block_bytes(self.cfg, self.blocks.block_size)

    def _ensure_blocks(
        self, req: Request, new_total: int, plan: Optional[IterationPlan] = None
    ) -> bool:
        """Grow ``req`` to ``new_total`` tokens, preempting offline victims
        under memory pressure, then -- for a running online ``req`` only --
        younger online ones (``_pick_online_victim``).  Never preempts
        requests already placed in the current plan.  Returns False if
        memory cannot be found."""
        planned_ids = set()
        if plan is not None:
            planned_ids = {r.request_id for r in plan.decode_reqs} | {
                c.request.request_id for c in plan.prefill_chunks
            }
        while True:
            if self.blocks.can_allocate(req.request_id, new_total):
                try:
                    self.blocks.grow(req.request_id, new_total)
                    return True
                except OutOfBlocks:
                    # exhaustion past the pre-check (injected alloc.grow
                    # fault): degrade into the same victim hunt as genuine
                    # pressure instead of raising into the engine loop
                    self.degraded["alloc_retry"] += 1
            victim = self._pick_memory_victim(exclude=req, planned=planned_ids)
            if victim is None:
                victim = self._pick_online_victim(req, planned_ids)
            if victim is None:
                return False
            self._preempt_offline(victim)
            if plan is not None:
                plan.preempted.append(victim)

    def _cow_for_write(
        self,
        req: Request,
        lo: int,
        hi: int,
        plan: Optional[IterationPlan] = None,
    ) -> bool:
        """Copy-on-write barrier for this iteration's KV write to token
        positions ``[lo, hi)``: blocks the request shares (refcount > 1)
        are swapped for exclusive copies in its table, and a
        ``("cow", req, pairs)`` event tells the engine which O(block)
        device copies to issue *before* the batch dispatches
        (DESIGN.md §14).  Preempts offline victims when the copies need
        pool blocks, mirroring ``_ensure_blocks``.  Returns False if
        memory cannot be found."""
        planned_ids = set()
        if plan is not None:
            planned_ids = {r.request_id for r in plan.decode_reqs} | {
                c.request.request_id for c in plan.prefill_chunks
            }
        while True:
            try:
                pairs = self.blocks.prepare_write(req.request_id, lo, hi)
            except OutOfBlocks:
                self.degraded["cow_retry"] += 1
                victim = self._pick_memory_victim(
                    exclude=req, planned=planned_ids
                )
                if victim is None:
                    victim = self._pick_online_victim(req, planned_ids)
                if victim is None:
                    return False
                self._preempt_offline(victim)
                if plan is not None:
                    plan.preempted.append(victim)
                continue
            if pairs:
                self.events.append(("cow", req, pairs))
            return True

    def _pick_memory_victim(
        self, exclude: Request, planned: set
    ) -> Optional[Request]:
        """Offline victim for memory reclamation: fully-checkpointed first
        (free discard), then most-recently-started (LIFO, like vLLM)."""
        offline_running = [
            r
            for r in self.running
            if not r.is_online
            and r is not exclude
            and r.request_id not in planned
        ]
        if not offline_running:
            return None
        ckpt = [
            r
            for r in offline_running
            if self.blocks.is_fully_checkpointed(r.request_id)
        ]
        if ckpt:
            return ckpt[-1]
        return offline_running[-1]

    def _pick_online_victim(
        self, req: Request, planned: set
    ) -> Optional[Request]:
        """Online victim for a *running* online request that cannot grow
        once no offline victim is left: the most recently admitted running
        online request admitted after ``req`` (``running`` order; a resumed
        request re-enters at its end) and not yet in the plan.  Never
        ``req`` itself, never an older request, and never for a waiting
        request's admission, so the oldest running online request can
        always take the whole pool and every online request finishes.
        Without it, online requests that together exceed the pool wait for
        each other forever."""
        if not req.is_online or req not in self.running:
            return None
        younger = self.running[self.running.index(req) + 1 :]
        for r in reversed(younger):
            if r.is_online and r.request_id not in planned:
                return r
        return None

    def _preempt_offline(self, req: Request) -> None:
        """PREEMPTSCHEDULING (Alg. 1 line 29): discard or swap out.  Also
        preempts an online victim of ``_pick_online_victim``, which resumes
        through the same recompute path ahead of offline work."""
        if req not in self.running:
            raise AssertionError(
                f"preempting non-resident request {req.request_id}"
            )
        swapped = False
        if self.sc.swap_on_preempt and not self.blocks.is_fully_checkpointed(
            req.request_id
        ):
            try:
                # copies: (block_index, device_block, host_block) triples —
                # the engine extracts these pool blocks before reuse
                copies = self.blocks.preempt_swap_out(req.request_id)
                recoverable = req.total_len
                self.events.append(("preempt_swap", req, copies))
                swapped = True
            except OutOfBlocks:
                # host pool full: fall back to discard (vLLM behaviour)
                self.degraded["swap_fallback"] += 1
        if not swapped:
            _, freed = self.blocks.preempt_discard(req.request_id)
            recoverable = self.blocks.tokens_recoverable_from_host(req.request_id)
            self.events.append(("preempt_discard", req, freed))
        req.on_preempt(recoverable)
        self.running.remove(req)
        self.preempted.append(req)

    _sat_cache: Optional[int] = None

    def _saturation_tokens(self) -> int:
        """Tokens per iteration that saturate the accelerator's compute
        ("largest batch size that can saturate GPU compute", §4.2): past the
        roofline knee, bigger batches add latency without throughput.
        Estimated from the latency model: n where the fixed cost (weight
        load + dispatch) is <=25% of the iteration."""
        if self._sat_cache is None:
            from .profiler import BatchShape

            base = self.model.iter_time(
                BatchShape(prefill_tokens=1, prefill_attn_tokens=1.0,
                           prefill_ctx_end=1, num_seqs=1)
            )
            big_n = 8192
            big = self.model.iter_time(
                BatchShape(prefill_tokens=big_n,
                           prefill_attn_tokens=float(big_n) * 512,
                           prefill_ctx_end=big_n, num_seqs=8)
            )
            per_tok = max((big - base) / big_n, 1e-9)
            self._sat_cache = max(2048, int(4 * base / per_tok))
        return self._sat_cache

    # ------------------------------------------------------------- main plan
    def plan_iteration(self, now: float) -> IterationPlan:
        """Algorithm 1, one scheduling step."""
        plan = IterationPlan()
        self._reap_finished()

        online_decode = [
            r for r in self.running if r.is_online and r.phase == Phase.DECODE
        ]
        online_prefill = [
            r for r in self.running if r.is_online and r.phase == Phase.PREFILL
        ]
        offline_decode = [
            r for r in self.running if not r.is_online and r.phase == Phase.DECODE
        ]
        offline_prefill = [
            r for r in self.running if not r.is_online and r.phase == Phase.PREFILL
        ]

        offline_mode = not self.has_online_work
        if offline_mode:
            # Offline batching mode (Alg. 1 lines 20-22): lift the budget to
            # the saturation point (auto-derived from the latency model's
            # roofline knee when left at the default); responsiveness comes
            # from safepoints.  An explicit finite cap is honored verbatim.
            cap = self.sc.offline_batch_tokens
            if cap >= (1 << 29):
                cap = self._saturation_tokens()
            budget = TokenBudget(
                max_total_tokens=cap, max_seqs=self.sc.max_batch_seqs
            )
        elif self.sc.slo_aware:
            has_decode = bool(online_decode)
            budget = calc_budget(
                self.model,
                self.slo,
                has_decode=has_decode,
                avg_ctx=self.sc.avg_ctx_estimate,
                max_seqs=self.sc.max_batch_seqs,
                headroom=self.sc.budget_headroom,
                # floor: one chunk must always fit, or huge online prompts
                # starve — but on slow substrates (measured CPU profiles) a
                # large fixed floor would swamp the SLO bound, so tie it to
                # the configured chunk rather than a hardware-era constant
                min_tokens=self.sc.chunk_size,
            )
        else:  # vLLM++ ablation: priority order but throughput-greedy budget
            budget = TokenBudget(
                max_total_tokens=self.sc.offline_batch_tokens,
                max_seqs=self.sc.max_batch_seqs,
            )
        plan.budget = budget
        scheduled = 0

        # ---- 1. online decodes: always first, one token each --------------
        for r in online_decode:
            if not self._ensure_blocks(r, r.total_len + 1, plan):
                break  # pathological: memory full of online requests
            if not self._cow_for_write(r, r.total_len - 1, r.total_len, plan):
                break
            plan.decode_reqs.append(r)
            plan.shape = plan.shape.merge(decode_shape(r.total_len, self.cfg))
            scheduled += 1

        # ---- 2. online prefills (running chunked first, then waiting) -----
        scheduled = self._schedule_prefills(
            plan, online_prefill, budget, scheduled, now
        )
        # online requests preempted by an older online one that could not
        # grow come back before new online work and before any offline work
        scheduled = self._resume_preempted(
            plan, budget, scheduled, now, online=True
        )
        admitted = self._admit_waiting(
            plan, self.online_q, budget, scheduled, now
        )
        scheduled = admitted

        # ---- 3. preempt over-budget offline (Alg. 1 line 16) --------------
        # Offline decodes join only within what remains.  Under online
        # pressure, over-budget offline decodes are preempted (freeing memory
        # and budget); in offline mode they simply wait unscheduled (keeping
        # their KV — continuous batching rotates them in later).
        room = budget.remaining(scheduled)
        fit, spill = offline_decode[:room], offline_decode[room:]
        if spill and self.has_online_work:
            for r in spill:
                if r.phase == Phase.PREEMPTED:
                    continue  # already a memory victim earlier in this plan
                self._preempt_offline(r)
                plan.preempted.append(r)
        for r in fit:
            if r.phase == Phase.PREEMPTED:
                continue  # became a memory victim earlier in this plan
            if not self._ensure_blocks(r, r.total_len + 1, plan):
                self._preempt_offline(r)
                plan.preempted.append(r)
                continue
            if not self._cow_for_write(r, r.total_len - 1, r.total_len, plan):
                self._preempt_offline(r)
                plan.preempted.append(r)
                continue
            plan.decode_reqs.append(r)
            plan.shape = plan.shape.merge(decode_shape(r.total_len, self.cfg))
            scheduled += 1

        # ---- 4. offline fills the residual budget --------------------------
        scheduled = self._schedule_prefills(
            plan, offline_prefill, budget, scheduled, now
        )
        # resume preempted offline before admitting fresh ones (fairness +
        # bounded recompute debt)
        scheduled = self._resume_preempted(
            plan, budget, scheduled, now, online=False
        )
        scheduled = self._admit_waiting(
            plan, self.offline_q, budget, scheduled, now
        )

        plan.pure_offline = not any(
            r.is_online
            for r in plan.decode_reqs + [c.request for c in plan.prefill_chunks]
        ) and not plan.empty
        self.current_plan = plan
        self.t_sched = now
        return plan

    # ----------------------------------------------------- scheduling pieces
    def _schedule_prefills(
        self,
        plan: IterationPlan,
        reqs: List[Request],
        budget: TokenBudget,
        scheduled: int,
        now: float,
    ) -> int:
        for r in reqs:
            if r.phase == Phase.PREEMPTED:
                continue  # became a memory victim earlier in this plan
            room = budget.remaining(scheduled)
            if room <= 0:
                break
            chunk = min(r.prefill_remaining, self.sc.chunk_size, room)
            if chunk <= 0:
                continue
            if not self._ensure_blocks(r, r.num_prefilled + chunk, plan):
                break
            if not self._cow_for_write(
                r, r.num_prefilled, r.num_prefilled + chunk, plan
            ):
                break
            plan.prefill_chunks.append(
                PrefillChunk(r, offset=r.num_prefilled, length=chunk)
            )
            plan.shape = plan.shape.merge(
                prefill_chunk_shape(r.num_prefilled, chunk, self.cfg)
            )
            scheduled += chunk
        return scheduled

    def _admit_waiting(
        self,
        plan: IterationPlan,
        queue: List[Request],
        budget: TokenBudget,
        scheduled: int,
        now: float,
    ) -> int:
        admitted: List[Request] = []
        for r in queue:
            room = budget.remaining(scheduled)
            if room <= 0 or plan.shape.num_seqs >= budget.max_seqs:
                break
            if not self.blocks.has_seq(r.request_id):
                # Registration consults the content index: a shared-prefix
                # hit maps existing pool blocks into the new table and the
                # request starts prefilling at the first uncached token —
                # the plan prices only the suffix (DESIGN.md §14).
                sb = self.blocks.register_seq(r.request_id, tokens=r.prompt)
                if sb.num_cached:
                    r.num_prefilled = sb.num_cached
                    r.prefix_cached = sb.num_cached
            chunk = min(r.prefill_remaining, self.sc.chunk_size, room)
            if chunk <= 0:
                break
            if not self._ensure_blocks(r, r.num_prefilled + chunk, plan):
                if r.is_online:
                    # keep trying victims is done inside _ensure_blocks; if it
                    # failed, memory is full of online work — stop admitting.
                    pass
                break
            if not self._cow_for_write(
                r, r.num_prefilled, r.num_prefilled + chunk, plan
            ):
                break
            r.phase = Phase.PREFILL
            if r.first_scheduled_time is None:
                r.first_scheduled_time = now
            self.running.append(r)
            admitted.append(r)
            plan.prefill_chunks.append(
                PrefillChunk(r, offset=r.num_prefilled, length=chunk)
            )
            plan.shape = plan.shape.merge(
                prefill_chunk_shape(r.num_prefilled, chunk, self.cfg)
            )
            scheduled += chunk
        for r in admitted:
            queue.remove(r)
        return scheduled

    def _resume_preempted(
        self,
        plan: IterationPlan,
        budget: TokenBudget,
        scheduled: int,
        now: float,
        online: bool = False,
    ) -> int:
        """Bring preempted requests of one class back (``online``): swap-in
        is planned by the checkpointer/prefetcher; recompute-needed tokens
        re-enter as prefill chunks here."""
        still: List[Request] = []
        for r in self.preempted:
            if r.is_online != online:
                still.append(r)
                continue
            room = budget.remaining(scheduled)
            if room <= 0 or not self.blocks.can_resume(r.request_id):
                still.append(r)
                continue
            if self.io_gate is not None and not self.io_gate():
                # host link saturated: defer swap-in to a later round
                still.append(r)
                continue
            try:
                copies = self.blocks.resume(r.request_id)
            except OutOfBlocks:
                # exhaustion past can_resume (injected alloc.resume fault):
                # the request simply stays preempted for a later round —
                # never raise into the engine loop (DESIGN.md §16)
                self.degraded["resume_deferred"] += 1
                still.append(r)
                continue
            self.events.append(("resume", r, copies))
            # tokens recoverable from host come back via (background) swap-in;
            # the rest is recompute -> prefill chunks
            r.num_prefilled = r.host_recoverable
            r.phase = Phase.PREFILL if r.prefill_remaining else Phase.DECODE
            self.running.append(r)
            chunk = min(r.prefill_remaining, self.sc.chunk_size, room)
            if chunk > 0:
                # resume() re-allocates only the tokens the sequence held
                # when it was preempted; the recompute chunk can run past
                # them, so grow (and copy on write) like every other chunk
                # write, or the chunk's KV lands in the engine's scratch
                # block.  A request that cannot grow stays running unplanned.
                if not (
                    self._ensure_blocks(r, r.num_prefilled + chunk, plan)
                    and self._cow_for_write(
                        r, r.num_prefilled, r.num_prefilled + chunk, plan
                    )
                ):
                    continue
                plan.prefill_chunks.append(
                    PrefillChunk(r, offset=r.num_prefilled, length=chunk)
                )
                plan.shape = plan.shape.merge(
                    prefill_chunk_shape(r.num_prefilled, chunk, self.cfg)
                )
                scheduled += chunk
            elif r.phase == Phase.DECODE:
                # the decode token's slot may lie past the resumed blocks too
                if not self._ensure_blocks(r, r.total_len + 1, plan):
                    continue
                plan.decode_reqs.append(r)
                plan.shape = plan.shape.merge(
                    decode_shape(r.total_len, self.cfg)
                )
                scheduled += 1
        self.preempted = still
        return scheduled

    # ------------------------------------------------------- plan preview
    def snapshot(self) -> "SchedulerSnapshot":
        """Checkpoint everything ``plan_iteration`` can mutate, so a plan
        can be built *speculatively* and rolled back with ``restore`` if it
        is invalidated before dispatch (the pipelined engine's
        double-buffering, DESIGN.md §13).

        Covers the queues/running/preempted/finished lists, the pending
        engine events, the block manager's accounting, and the per-request
        fields planning touches (phase, prefill progress, preemption
        bookkeeping, first-scheduled time).  Token progress
        (``num_generated`` / ``output_tokens``) is commit-owned and never
        moves at plan time, so it is deliberately not captured.
        """
        reqs = self.all_requests()
        return SchedulerSnapshot(
            online_q=list(self.online_q),
            offline_q=list(self.offline_q),
            running=list(self.running),
            preempted=list(self.preempted),
            finished=list(self.finished),
            events=list(self.events),
            t_sched=self.t_sched,
            current_plan=self.current_plan,
            blocks=self.blocks.snapshot(),
            known_ids={id(r) for r in reqs},
            req_state=[
                (
                    r,
                    r.phase,
                    r.num_prefilled,
                    r.num_preemptions,
                    r.host_recoverable,
                    r.first_scheduled_time,
                    r.prefix_cached,
                )
                for r in reqs
            ],
            degraded=dict(self.degraded),
        )

    def restore(self, snap: "SchedulerSnapshot") -> None:
        """Discard a speculative plan: rewind to ``snap``, keeping requests
        submitted *after* the snapshot queued (arrivals are exactly what
        invalidates a staged plan — they must survive the rollback and be
        replanned, never dropped)."""
        new_online = [r for r in self.online_q if id(r) not in snap.known_ids]
        new_offline = [r for r in self.offline_q if id(r) not in snap.known_ids]
        self.online_q = list(snap.online_q) + new_online
        self.offline_q = list(snap.offline_q) + new_offline
        self.running = list(snap.running)
        self.preempted = list(snap.preempted)
        self.finished = list(snap.finished)
        self.events = list(snap.events)
        self.t_sched = snap.t_sched
        self.current_plan = snap.current_plan
        self.blocks.restore(snap.blocks)
        self.degraded = dict(snap.degraded)
        for r, phase, npref, npre, hrec, fst, pcache in snap.req_state:
            r.phase = phase
            r.num_prefilled = npref
            r.num_preemptions = npre
            r.host_recoverable = hrec
            r.first_scheduled_time = fst
            r.prefix_cached = pcache

    def _reap_finished(self) -> None:
        done = [r for r in self.running if r.phase == Phase.FINISHED]
        for r in done:
            self.running.remove(r)
            if self.blocks.has_seq(r.request_id):
                self.blocks.free_seq(r.request_id)
            self.finished.append(r)

    # ------------------------------------------------------------- commit
    def commit(
        self,
        plan: IterationPlan,
        now: float,
        aborted: bool = False,
        tokens: Optional[Dict[int, int]] = None,
    ) -> None:
        """Apply the results of an executed (or aborted) iteration.

        ``tokens`` (real-execution mode) maps request_id -> sampled token for
        every request that produced one this iteration; simulated mode leaves
        it None and only counts."""
        self.current_plan = None
        if aborted:
            # Partial iteration discarded (Alg. 2 / §4.3): KV for *previous*
            # tokens is intact (stateless inference) — only this iteration's
            # would-be outputs are lost.  Requests simply stay schedulable.
            return

        def tok(r: Request) -> Optional[int]:
            return None if tokens is None else tokens.get(r.request_id)

        for chunk in plan.prefill_chunks:
            r = chunk.request
            r.num_prefilled += chunk.length
            # Publish newly completed full prompt blocks into the content
            # index — only now, at commit: speculative or aborted work must
            # never become a cache source (DESIGN.md §14).
            self.blocks.commit_prefix(r.request_id, r.num_prefilled)
            if r.prefill_remaining == 0:
                # prompt fully prefilled: first token is produced by this
                # same iteration (prefill emits the first logits)
                if r.num_generated == 0:
                    r.record_token(now, tok(r))
                    # the emitted token occupies KV on the *next* decode
                    r.phase = Phase.DECODE if not r.done else Phase.FINISHED
                else:
                    # resumed recompute complete
                    r.phase = Phase.DECODE
        for r in plan.decode_reqs:
            r.record_token(now, tok(r))
        self._reap_finished()

    # ----------------------------------------------------------- Algorithm 2
    def on_online_arrival(self, req: Request, now: float) -> bool:
        """Urgent-path handler (Algorithm 2).  Returns True if the running
        batch must be preempted at the next safepoint to meet TTFT."""
        self.submit(req)
        if not self.sc.preempt_running:
            return False
        plan = self.current_plan
        if plan is None or plan.empty or not plan.pure_offline:
            return False  # co-serving batches are already budget-bounded
        t_est = self.model.iter_time(plan.shape)
        t_remain = t_est - (now - self.t_sched)
        if t_remain <= 0.0:
            # Overdue relative to the estimate.  We are being consulted from
            # inside the still-running batch (its safepoints call this), so
            # "zero remaining" is impossible — the profile was optimistic.
            # Keep one safepoint interval as the conservative remainder so a
            # mis-estimated long batch can still be preempted.  (Pure config
            # arithmetic — same formula as transformer.num_segments, inlined
            # to keep the policy core free of model-layer imports.)
            periods_per_seg = max(
                1, self.cfg.safepoint_interval // self.cfg.pattern_period
            )
            nseg = -(-self.cfg.num_periods // periods_per_seg)
            t_remain = t_est / max(1, nseg)
        # time to serve the waiting online queue once this batch drains
        q_shape = BatchShape()
        for r in self.online_q:
            q_shape = q_shape.merge(
                prefill_chunk_shape(0, min(r.prefill_remaining, self.sc.chunk_size), self.cfg)
            )
        t_exec = self.model.iter_time(q_shape)
        if t_remain + t_exec > self.slo.ttft:
            self.preempt_flag = True
            return True
        return False
