"""Real-execution co-serving engine in PyTorch: the ConServe policies
(UnifiedScheduler / Checkpointer / safepoints) driving the port's model on
a CUDA card (or the CPU, when the caller asks for it).

Counterpart of ``src/repro/serving/real_engine.py`` restricted to its
serial single-device paths: the paged KV pool with the fused ragged batch
(``fused_batch=True``, the default) or the split per-family dispatches
(``fused_batch=False``, the fused path's differential oracle), and the
contiguous per-request caches (``backend="contiguous"``); the serial engine
(``pipeline=False``) and a single device (``mesh=None``).  Any other
setting, and any architecture but a dense causal full-attention stack,
raises ``NotImplementedError`` naming the ROADMAP item that brings it.

* Physical KV layout: shared pools ``(num_periods, num_device_blocks + 1,
  block_size, Hkv, D)`` per pattern position, updated in place; the last
  row is a scratch block that absorbs writes from padded tokens.
* Fused: every iteration lowers the whole ``IterationPlan`` (online decodes
  plus offline prefill chunks) to ONE flattened ragged token batch
  (``_build_ragged``), padded to power-of-two (T, S, Qmax) buckets, and runs
  it one K-layer segment at a time with safepoint checks between segments.
  Each layer scatters the new KV and runs the ragged paged-attention kernel
  once.
* Split: the plan's prefill chunks run as bucket-batched
  ``prefill_chunk_paged`` dispatches (plain attention over the gathered
  context, as in the reference), then its decodes as one
  ``decode_step_paged`` at a power-of-two batch bucket, segment by segment
  when the plan is preemptible; each decode layer runs the paged decode
  attention kernel once.
* Contiguous: one B=1 cache per request (``self.caches``), each leaf
  (P, 1, max_model_len, ...).  Each prefill chunk is one ``prefill_chunk``
  dispatch per request, whose attention runs the flash attention kernel in
  every layer; the plan's decodes concatenate their requests' caches into
  one batch, run ``decode_step`` (segment by segment when preemptible:
  ``run_segment``, plain masked attention over the cache, as in the
  reference) and slice the batch back.  Checkpoints copy cache slots to the
  host, a swap-out does the same, a discard drops the cache, and a resume
  builds a fresh cache and restores the stored blocks into it.
* ``calibrate()`` times the engine's own dispatches over the serve-time
  shape grid on the host clock (dispatch plus device synchronisation) and
  installs the fitted ``MeasuredProfiler`` as the scheduler's latency model.
* Incremental checkpointing gathers the chosen pages of every period-stacked
  pool leaf with the ``checkpoint_gather`` kernel into one device staging
  buffer, copies it to pinned host memory in one transfer, and stores one
  block per entry in ``HostKVStore``; a resume scatters them back into
  whatever physical blocks it re-allocated.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.budget import pow2_bucket
from ..core.checkpoint import AdaptiveCheckpointPolicy, Checkpointer, HostKVStore
from ..core.faults import InjectedFault, RequestFailed
from ..core.preemption import PreemptionFlag, SegmentedExecution
from ..core.profiler import (
    AnalyticalCostModel,
    BatchShape,
    CalibrationGrid,
    MeasuredProfiler,
    block_bytes,
    calibrate,
    h100_spec,
)
from ..core.request import Request
from ..core.scheduler import SchedulerConfig, UnifiedScheduler
from ..core.slo import SLO
from ..kernels import ops as kernel_ops
from ..kvcache import cache_ops
from ..kvcache.block_manager import BlockManager
from ..models import transformer as tf
from ..models.config import ModelConfig
from ..models.layers import RaggedMeta
from ..models.sampling import SamplingParams, sample


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist (there is
    no silent fallback to the CPU).  A CUDA device without an index gets the
    calling thread's current one, so the engine's tensors stay on that card
    when another thread (the wall-clock runtime's engine thread, whose
    current device is its own) drives it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


@dataclass
class RealEngineConfig:
    max_model_len: int = 256
    block_size: int = 16
    num_device_blocks: int = 256
    num_host_blocks: int = 1024
    enable_checkpointing: bool = True
    enable_safepoints: bool = True
    max_steps: int = 100_000
    # "auto": paged when the arch supports it; "paged"/"contiguous" force.
    backend: str = "auto"
    # largest batched-prefill dispatch of the split path (a bigger prefill
    # wave is split into several dispatches, each boundary a safepoint of
    # pure-offline plans); the fused path has no per-dispatch batch cap
    max_prefill_batch: int = 8
    # Fused mixed-batch execution (DESIGN.md §12); False runs the split
    # per-family dispatches, the fused path's differential oracle.
    fused_batch: bool = True
    # The settings below exist for parity with the reference; only their
    # defaults run in the port.
    pipeline: bool = False
    mesh: Optional[Any] = None
    # Shared-prefix KV caching with copy-on-write block sharing (§14).
    prefix_cache: bool = True
    # Deterministic fault injection (core.faults.FaultInjector, §16).
    faults: Optional[Any] = None


class RealEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        sched_cfg: Optional[SchedulerConfig] = None,
        eng_cfg: RealEngineConfig = RealEngineConfig(),
        slo: SLO = SLO(),
        sampling: SamplingParams = SamplingParams(),
        clock=None,
        device="cuda",
    ):
        if eng_cfg.backend not in ("auto", "paged", "contiguous"):
            raise ValueError(f"unknown backend {eng_cfg.backend!r}")
        if eng_cfg.backend == "paged" and not tf.supports_paged(cfg):
            raise ValueError(f"{cfg.name}: arch cannot run the paged backend")
        # every arch the port runs is a dense causal full-attention stack,
        # which runs paged or contiguous; the others fall back to the
        # contiguous layout in the reference and raise here (ROADMAP Queue 1,
        # the contiguous fallback's other archs)
        tf._check_supported(cfg)
        self.paged = eng_cfg.backend != "contiguous"
        if eng_cfg.pipeline:
            raise NotImplementedError(
                "the async pipeline is not ported yet (ROADMAP Queue 1: the "
                "async pipeline)"
            )
        if eng_cfg.mesh is not None:
            raise NotImplementedError(
                "tensor-parallel serving is not ported yet (ROADMAP Queue 1: "
                "tensor parallelism)"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = to_device(params, self.device)
        self.dtype = self.params["embed"].dtype
        self.ec = eng_cfg
        self.fused = self.paged and eng_cfg.fused_batch
        self.sampling = sampling
        self._clock = clock or time.perf_counter

        self.blocks = BlockManager(
            eng_cfg.num_device_blocks, eng_cfg.num_host_blocks,
            eng_cfg.block_size, prefix_cache=eng_cfg.prefix_cache and self.paged,
        )
        # Fault injection (DESIGN.md §16): the manager arms the pool points,
        # the engine the dispatch points; _step_snap is the pre-iteration
        # scheduler snapshot a request-scoped fault rolls back to.
        self.faults = eng_cfg.faults
        self.blocks.faults = self.faults
        self._step_snap = None
        sched_cfg = sched_cfg or SchedulerConfig(
            chunk_size=32, slo_aware=False, offline_batch_tokens=4096
        )
        if sched_cfg.max_model_len is None:
            sched_cfg = dataclasses.replace(
                sched_cfg, max_model_len=eng_cfg.max_model_len
            )
        hw = h100_spec(
            torch.cuda.get_device_name(self.device)
            if self.device.type == "cuda" else ""
        )
        lat = AnalyticalCostModel(cfg, hw)  # the prior until measured
        self.sched = UnifiedScheduler(cfg, lat, slo, self.blocks, sched_cfg)

        # KV-block checkpoint/restore is exact for every arch the port runs
        # (plain causal full attention, paged or contiguous)
        self.ckpt = Checkpointer(
            self.blocks,
            AdaptiveCheckpointPolicy(start_threshold=0.0),  # always checkpoint
            block_bytes(cfg, eng_cfg.block_size),
            enabled=eng_cfg.enable_checkpointing,
        )
        self.flag = PreemptionFlag()
        self.safepoints = SegmentedExecution(self.flag)
        self.host = HostKVStore()  # (seq, block_index) -> KV block tensors
        self.steps = 0
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        # distinct (T, S, Qmax) bucket triples the fused path has run: the
        # bound on the shapes a CUDA graph capture would need
        self.fused_buckets: set = set()
        self.cow_dispatches = 0  # COW block-copy rounds run on device
        self.ckpt_gathers = 0  # checkpoint gather rounds (one staging copy each)
        self.restored_blocks = 0  # host blocks scattered back by resumes
        # model dispatches by entry point, under the reference's names
        self.dispatches: Dict[str, int] = {
            "prefill": 0, "decode": 0, "segment": 0,
            "fused_segment": 0, "fused_logits": 0,
        }
        self.profile: Optional[MeasuredProfiler] = None  # set by calibrate()
        # Runtime hook: called at every safepoint of a pure-offline batch.
        self.arrival_poll: Optional[Callable[[], None]] = None
        # When a dict, each sampled token's top-1 minus top-2 logit is
        # appended under its request id (the near-tie guard of the tests).
        self.margins: Optional[Dict[int, List[float]]] = None
        # Host-gap and calibration-drift instrumentation (DESIGN.md §13/§15).
        self._t_last_enqueue: Optional[float] = None
        self._last_event: Optional[torch.cuda.Event] = None
        self.host_gap_s: List[float] = []
        self.host_gap_count = 0
        self.host_gap_seconds = 0.0
        # staged batches invalidated before dispatch: the async pipeline is
        # not ported, so this stays 0 (read by the wall-clock runtime)
        self.pipeline_discards = 0
        self.measured_iter_seconds = 0.0
        self.predicted_iter_seconds = 0.0
        self.measured_iters = 0

        self._scratch_block = eng_cfg.num_device_blocks
        self._table_width = self.blocks.blocks_for_tokens(eng_cfg.max_model_len)
        if self.paged:
            self.pools = tf.init_paged_pools(
                cfg, eng_cfg.num_device_blocks + 1, eng_cfg.block_size,
                dtype=self.dtype, device=self.device,
            )
        else:
            self.caches: Dict[int, Any] = {}  # request_id -> B=1 cache tree

    @property
    def fused_trace_count(self) -> int:
        """Distinct (T, S, Qmax) buckets run, the reference's retrace count."""
        return len(self.fused_buckets)

    # ------------------------------------------------------------------ api
    def set_clock(self, clock: Callable[[], float]) -> None:
        self._clock = clock

    def submit(self, req: Request) -> None:
        """Queue a request.  Raises ``core.scheduler.AdmissionError`` before
        any block is allocated if the request cannot fit ``max_model_len``."""
        if req.prompt is None:
            raise ValueError("real engine requires prompt token ids")
        self.sched.submit(req)

    def on_online_arrival(self, req: Request) -> None:
        """Streaming-API entry: may trip the preemption flag (Algorithm 2)."""
        if req.prompt is None:
            raise ValueError("real engine requires prompt token ids")
        if self.sched.on_online_arrival(req, self._clock()):
            self.flag.set()

    def _on_safepoint(self, seg_idx: int) -> None:
        if self.arrival_poll is not None:
            self.arrival_poll()

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # ---------------------------------------------------------------- tokens
    def _tokens_of(self, req: Request) -> np.ndarray:
        return np.concatenate(
            [np.asarray(req.prompt, np.int32),
             np.asarray(req.output_tokens, np.int32)]
        )

    def _block_table(self, rid: int) -> np.ndarray:
        return np.asarray(
            self.blocks.block_table(rid, self._table_width,
                                    pad=self._scratch_block),
            np.int32,
        )

    # ------------------------------------------------------ pool block moves
    def _leaves(self) -> List[Tuple[str, str]]:
        return [(pos, kv) for pos in self.pools for kv in ("k", "v")]

    def _extract_blocks_paged(self, dev_blocks: List[int]) -> List[Any]:
        """Gather the chosen physical blocks of every pool leaf with the
        ``checkpoint_gather`` kernel into one device staging buffer, copy it
        to pinned host memory in one transfer, and return one stored dict
        per block (``{pos: {"k", "v"}}`` of (P, page, Hkv, D) CPU views), in
        ``dev_blocks`` order.  The id list pads to a power-of-two bucket
        with the scratch block, like the reference's jitted gather."""
        n = len(dev_blocks)
        pad = pow2_bucket(n)
        ids = self._put(np.asarray(
            list(dev_blocks) + [self._scratch_block] * (pad - n), np.int32
        ))
        leaves = self._leaves()
        first = self.pools[leaves[0][0]][leaves[0][1]]
        shape = (len(leaves), first.shape[0], pad, *first.shape[2:])
        staging = torch.empty(shape, dtype=self.dtype, device=self.device)
        for li, (pos, kv) in enumerate(leaves):
            kernel_ops.checkpoint_gather(self.pools[pos][kv], ids,
                                         out=staging[li])
        self.ckpt_gathers += 1
        if self.device.type == "cuda":
            host = torch.empty(shape, dtype=self.dtype, pin_memory=True)
            host.copy_(staging, non_blocking=True)
            # the bytes are read as soon as this returns
            torch.cuda.current_stream(self.device).synchronize()
        else:
            host = staging
        stored = [{pos: {} for pos in self.pools} for _ in range(n)]
        for li, (pos, kv) in enumerate(leaves):
            for i in range(n):
                stored[i][pos][kv] = host[li][:, i]
        return stored

    def _restore_blocks_paged(self, dev_blocks: List[int], stored: List[Any]):
        """Scatter host-stored blocks into (re-allocated) physical pool
        slots, in place: one host-to-device copy and one scatter per leaf."""
        ids = torch.tensor(dev_blocks, dtype=torch.long, device=self.device)
        self.restored_blocks += len(dev_blocks)
        for pos, kv in self._leaves():
            blocks = torch.stack([s[pos][kv] for s in stored], dim=1)
            self.pools[pos][kv].index_copy_(
                1, ids, blocks.to(self.device, non_blocking=True)
            )

    def _cow_blocks_paged(self, pairs: List[tuple]) -> None:
        """Realize the block manager's copy-on-write decisions on device
        (DESIGN.md §14) before this iteration's KV writes."""
        src = torch.tensor([s for _i, s, _d in pairs], device=self.device)
        dst = torch.tensor([d for _i, _s, d in pairs], device=self.device)
        self.cow_dispatches += 1
        for pos, kv in self._leaves():
            cache_ops.copy_blocks(self.pools[pos][kv], src, dst, dim=1)

    # ------------------------------------------------------ contiguous layout
    def _fresh_cache(self, req: Request) -> Any:
        return tf.init_caches(self.cfg, 1, self.ec.max_model_len, dtype=self.dtype,
                              device=self.device)

    def _extract_block(self, cache: Any, block_idx: int) -> Any:
        """Host copy of one block's slots of every leaf of a B=1 cache:
        ``{pos: {"k", "v": (P, 1, bs, Hkv, D), "pos": (P, 1, bs)}}``."""
        lo = block_idx * self.ec.block_size
        hi = lo + self.ec.block_size
        return {pos: {name: leaf[:, :, lo:hi].to("cpu", copy=True)
                      for name, leaf in c.items()}
                for pos, c in cache.items()}

    def _restore_block(self, cache: Any, block_idx: int, stored: Any) -> Any:
        """Write a stored block back into its slots of ``cache``, in place."""
        lo = block_idx * self.ec.block_size
        for pos, leaves in stored.items():
            for name, blk in leaves.items():
                cache[pos][name][:, :, lo:lo + blk.shape[2]].copy_(blk)
        return cache

    # ---------------------------------------------------------------- events
    def _process_events(self) -> None:
        for kind, req, payload in self.sched.events:
            rid = req.request_id
            if kind in ("preempt_discard", "preempt_swap"):
                if kind == "preempt_swap" and payload:
                    # blocking swap-out of the un-checkpointed blocks
                    if self.paged:
                        stored = self._extract_blocks_paged(
                            [dev for _idx, dev, _host in payload]
                        )
                    else:
                        cache = self.caches.get(rid)
                        stored = [None if cache is None else self._extract_block(cache, idx)
                                  for idx, _dev, _host in payload]
                    for (idx, _dev, _host), blk in zip(payload, stored):
                        if blk is not None:
                            self.host.put(rid, idx, blk)
                if not self.paged:
                    self.caches.pop(rid, None)
                self.ckpt.unmark(req)  # discard: pure table edits (§4.4)
            elif kind == "cow":
                # duplicate shared blocks before this iteration's writes land
                # in them; host bytes of the re-written indices are stale
                if self.paged and payload:
                    self._cow_blocks_paged(payload)
                for idx, _src, _dst in payload:
                    self.host.pop(rid, idx)
            elif kind == "resume":
                nrec = self.blocks.blocks_for_tokens(req.host_recoverable)
                if self.paged:
                    sb = self.blocks.seq(rid)
                    devs, blks = [], []
                    for b in range(nrec):
                        stored = self.host.get(rid, b)
                        if stored is not None:
                            devs.append(sb.device_blocks[b])
                            blks.append(stored)
                    if devs:
                        self._restore_blocks_paged(devs, blks)
                else:
                    cache = self._fresh_cache(req)
                    for b in range(nrec):
                        stored = self.host.get(rid, b)
                        if stored is not None:
                            self._restore_block(cache, b, stored)
                            self.restored_blocks += 1
                    self.caches[rid] = cache
        self.sched.events.clear()

    # --------------------------------------------------- fault injection (§16)
    def _arm_iteration_faults(self, plan) -> None:
        """Arm the per-iteration dispatch fault points once per executed
        iteration, before any of its device work, so a rollback to the
        pre-iteration snapshot is exact."""
        if self.faults is None:
            return
        spec = self.faults.arm("dispatch.slow")
        if spec is not None and spec.delay_s > 0:
            self.faults.sleep(spec.delay_s)
        spec = self.faults.arm("dispatch")
        if spec is None:
            return
        if spec.scope == "request":
            rid = spec.request_id
            if rid is None:
                # default victim: first offline request in the plan
                reqs = [c.request for c in plan.prefill_chunks] + list(
                    plan.decode_reqs
                )
                offline = [r for r in reqs if not r.is_online]
                pick = (offline or reqs)[0] if (offline or reqs) else None
                rid = None if pick is None else pick.request_id
            if rid is not None:
                raise RequestFailed(
                    rid, f"injected dispatch fault at step {self.steps}"
                )
            return
        raise InjectedFault(
            f"injected engine-fatal dispatch fault at step {self.steps}"
        )

    def flush_pipeline(self) -> None:
        """Drain the engine's asynchronous artifacts before the wall-clock
        runtime reads metrics and tokens.  The serial engine has none: each
        step reads its sampled tokens back and synchronises its checkpoint
        copies, so this is a no-op (the async pipeline is ROADMAP Queue 1's
        item)."""

    def recover_from_fault(self) -> None:
        """Roll back to the pre-iteration cut after an exception escaped
        ``step()``, and drop manager host-table entries whose bytes a
        processed COW event already popped."""
        snap, self._step_snap = self._step_snap, None
        if snap is not None:
            self.sched.restore(snap)
        self.flag.clear()
        for sid in self.blocks.seq_ids():
            sb = self.blocks.seq(sid)
            for i, hb in enumerate(sb.host_blocks):
                if hb >= 0 and self.host.get(sid, i) is None:
                    self.blocks.drop_host_block(sid, i)

    def fail_request(self, req: Request) -> None:
        """Remove one request from every engine-side structure."""
        sched = self.sched
        for q in (sched.online_q, sched.offline_q, sched.running,
                  sched.preempted):
            if req in q:
                q.remove(req)
        self.ckpt.unmark(req)
        if self.blocks.has_seq(req.request_id):
            self.blocks.free_seq(req.request_id)
        self.host.drop_seq(req.request_id)
        if not self.paged:
            self.caches.pop(req.request_id, None)

    # ------------------------------------------------------------------ step
    def step(self) -> bool:
        """One engine iteration. Returns False when no work remains."""
        now = self._clock()
        sched = self.sched
        if self.faults is not None:
            self._step_snap = sched.snapshot()
        plan = sched.plan_iteration(now)
        self._process_events()
        if plan.empty:
            self._step_snap = None
            return bool(
                sched.online_q or sched.offline_q or sched.running
                or sched.preempted
            )
        self.steps += 1
        t_iter0 = time.perf_counter()
        predicted_s = self.sched.model.iter_time(plan.shape)
        self._arm_iteration_faults(plan)

        tokens: Dict[int, int] = {}
        preemptible = (
            plan.pure_offline
            and self.ec.enable_safepoints
            and sched.sc.preempt_running
        )
        if not preemptible:
            # a flag left set after an un-aborted batch must not leak into a
            # later pure-offline iteration as a spurious abort
            self.flag.clear()
        if self.fused:
            aborted = self._run_fused(plan, preemptible, tokens)
        else:
            if self.paged:
                aborted = self._prefill_paged_batched(plan, preemptible, tokens)
            else:
                aborted = False  # contiguous prefill has no safepoints
                self._prefill_contiguous(plan, tokens)
            if plan.decode_reqs and not aborted:
                decode = self._decode_paged if self.paged else self._decode_contiguous
                logits, aborted = decode(plan.decode_reqs, preemptible)
                if not aborted:
                    self._sample(logits, plan.decode_reqs, tokens)

        sched.commit(plan, self._clock(), aborted=aborted, tokens=tokens)
        self._step_snap = None
        self.measured_iter_seconds += time.perf_counter() - t_iter0
        self.predicted_iter_seconds += predicted_s
        self.measured_iters += 1
        if not self.paged:
            for rid in list(self.caches):
                if not self.blocks.has_seq(rid):
                    self.caches.pop(rid, None)
        for sid in self.host.seq_ids():
            if not self.blocks.has_seq(sid):
                self.host.drop_seq(sid)
        if not aborted:
            self._checkpoint_after(plan)
        return True

    def _checkpoint_after(self, plan) -> None:
        """Post-iteration incremental checkpointing: mark the offline
        sequences that just executed, pick blocks, copy them to the host."""
        executed_offline = [
            r for r in plan.decode_reqs if not r.is_online
        ] + [c.request for c in plan.prefill_chunks if not c.request.is_online]
        self.ckpt.mark(executed_offline)
        chosen = self.ckpt.plan(io_budget_blocks=1 << 30)
        if not chosen:
            return
        if not self.paged:
            for seq_id, idx, _dev, _host in chosen:
                cache = self.caches.get(seq_id)
                if cache is not None:
                    self.host.put(seq_id, idx, self._extract_block(cache, idx))
            return
        stored = self._extract_blocks_paged([c[2] for c in chosen])
        for (seq_id, idx, _dev, _host), blk in zip(chosen, stored):
            self.host.put(seq_id, idx, blk)

    # ------------------------------------------------- fused ragged execution
    def _build_ragged(self, items: List[tuple]) -> Dict[str, np.ndarray]:
        """Lower one iteration's sequences to flat ragged-batch arrays.

        ``items`` holds one ``(q_len, ctx_start, tokens|None, table|None)``
        per sequence; ``None`` builds a probe that addresses only the
        scratch row.  T (total tokens), S (sequences) and Qmax (longest query
        run) pad to power-of-two buckets; padded tokens scatter to the
        scratch row and padded query / sequence slots compute values that
        nothing reads back."""
        bs = self.ec.block_size
        t_pad = pow2_bucket(sum(it[0] for it in items))
        s_pad = pow2_bucket(len(items))
        qmax = pow2_bucket(max(it[0] for it in items))
        a = {
            "tokens": np.zeros((t_pad,), np.int32),
            "positions": np.zeros((t_pad,), np.int32),
            "dst_row": np.full((t_pad,), self._scratch_block, np.int32),
            "dst_off": np.zeros((t_pad,), np.int32),
            "tables": np.full(
                (s_pad, self._table_width), self._scratch_block, np.int32
            ),
            "qpad": np.full((s_pad, qmax), t_pad - 1, np.int32),
            "q_pos": np.zeros((s_pad, qmax), np.int32),
            "kv_lens": np.zeros((s_pad,), np.int32),
            "unpad_seq": np.full((t_pad,), s_pad - 1, np.int32),
            "unpad_j": np.zeros((t_pad,), np.int32),
            "logit_idx": np.full((s_pad,), t_pad - 1, np.int32),
        }
        start = 0
        for i, (qlen, ctx, toks, table) in enumerate(items):
            sl = slice(start, start + qlen)
            pos = ctx + np.arange(qlen, dtype=np.int32)
            if toks is not None:
                a["tokens"][sl] = toks
            a["positions"][sl] = pos
            if table is not None:  # None: a calibration probe, scratch row only
                a["tables"][i] = table
                a["dst_row"][sl] = table[pos // bs]
                a["dst_off"][sl] = pos % bs
            a["qpad"][i, :qlen] = start + np.arange(qlen, dtype=np.int32)
            a["q_pos"][i, :qlen] = pos
            a["kv_lens"][i] = ctx + qlen
            a["unpad_seq"][sl] = i
            a["unpad_j"][sl] = np.arange(qlen, dtype=np.int32)
            a["logit_idx"][i] = start + qlen - 1
            start += qlen
        return a

    def _fused_inputs(self, a: Dict[str, np.ndarray]):
        """Device-place one ragged batch."""
        meta = RaggedMeta(*(self._put(a[k]) for k in RaggedMeta._fields))
        return (
            self._put(a["tokens"]),
            self._put(a["tables"]),
            self._put(a["positions"][None]),
            meta,
            self._put(a["logit_idx"]),
        )

    def _run_segments(self, x, seg_fn, counter: str, preemptible: bool):
        """One dispatch per K-layer segment with host-side safepoint cuts
        between them.  Returns ``(x | None, aborted)``; on abort the flag is
        consumed."""
        state = {"x": x}

        def make_seg(lo, pps):
            def run():
                self.dispatches[counter] += 1
                state["x"] = seg_fn(lo, pps, state["x"])

            return run

        completed, _done = self.safepoints.run(
            [make_seg(lo, pps) for lo, pps in tf.segment_spans(self.cfg)],
            preemptible=preemptible,
            on_safepoint=self._on_safepoint,
        )
        if not completed:
            self.flag.clear()
            return None, True
        return state["x"], False

    def _dispatch_fused(self, toks, tables, positions, meta, logit_idx,
                        preemptible: bool):
        """Embed, run one dispatch per K-layer segment, then the S-row
        logits.  Returns (logits | None, aborted)."""
        if self._t_last_enqueue is not None:
            gap = time.perf_counter() - self._t_last_enqueue
            ev, self._last_event = self._last_event, None
            if ev is not None and not ev.query():
                gap = 0.0  # the device still had queued work: no idle
            self._t_last_enqueue = None
            self.host_gap_s.append(gap)
            self.host_gap_count += 1
            self.host_gap_seconds += gap
        x = tf.embed(self.cfg, self.params, toks[None])

        def seg(lo, pps, h):
            h, _ = tf.run_tokens_paged_at(
                self.cfg, self.params, pps, lo, h, self.pools, tables,
                positions, meta,
            )
            return h

        x, aborted = self._run_segments(x, seg, "fused_segment", preemptible)
        if aborted:
            return None, True
        self.dispatches["fused_logits"] += 1
        return tf.ragged_lm_head(self.cfg, self.params, x, logit_idx), False

    def _build_fused(self, plan) -> Tuple[List[tuple], tuple]:
        """Lower an ``IterationPlan`` to device-ready fused inputs.  Returns
        ``(samplers, inputs)``; ``samplers`` lists the ``(sequence row,
        request)`` pairs whose logits are sampled after the dispatch."""
        items: List[tuple] = []
        samplers: List[tuple] = []
        for c in plan.prefill_chunks:
            toks = self._tokens_of(c.request)[c.offset : c.offset + c.length]
            items.append(
                (c.length, c.offset, toks,
                 self._block_table(c.request.request_id))
            )
            if (
                c.offset + c.length == c.request.kv_target
                and c.request.num_generated == 0
            ):
                samplers.append((len(items) - 1, c.request))
        for r in plan.decode_reqs:
            items.append(
                (1, r.total_len - 1, self._tokens_of(r)[-1:],
                 self._block_table(r.request_id))
            )
            samplers.append((len(items) - 1, r))
        a = self._build_ragged(items)
        self.fused_buckets.add((len(a["tokens"]), *a["qpad"].shape))
        return samplers, self._fused_inputs(a)

    def _run_fused(self, plan, preemptible: bool, tokens: Dict[int, int]) -> bool:
        """Execute the whole ``IterationPlan`` as one fused ragged batch.
        Returns True if the iteration aborted at a safepoint (only
        pure-offline plans are preemptible)."""
        samplers, inputs = self._build_fused(plan)
        logits, aborted = self._dispatch_fused(*inputs, preemptible=preemptible)
        if aborted:
            return True
        if samplers:
            rows = torch.tensor([i for i, _ in samplers], device=self.device)
            self._sample(logits[rows], [r for _, r in samplers], tokens)
            self._last_event = None  # the readback above drained the device
        elif self.device.type == "cuda":
            self._last_event = torch.cuda.Event()
            self._last_event.record(torch.cuda.current_stream(self.device))
        self._t_last_enqueue = time.perf_counter()
        return False

    def _sample(self, logits: torch.Tensor, reqs: List[Request],
                tokens: Dict[int, int]) -> None:
        """One batched sample of ``logits`` (a row per request in ``reqs``)
        into ``tokens``; records top-2 margins when ``self.margins`` is set."""
        toks = sample(logits, self.sampling, self._gen).cpu().numpy()
        if self.margins is not None:
            top2 = torch.topk(logits, 2, dim=-1).values.cpu().numpy()
            for r, (a, b) in zip(reqs, top2):
                self.margins.setdefault(r.request_id, []).append(float(a - b))
        for r, t in zip(reqs, toks):
            tokens[r.request_id] = int(t)

    # ------------------------------------------------ split per-family paths
    @staticmethod
    def _chunk_bucket(n: int) -> int:
        return pow2_bucket(n, floor=8)

    def _prefill_paged_batched(
        self, plan, preemptible: bool, tokens: Dict[int, int]
    ) -> bool:
        """Run the plan's prefill chunks as bucket-batched dispatches.

        Chunks group by padded length bucket; each group (at most
        ``max_prefill_batch`` chunks) runs as ONE ``prefill_chunk_paged``
        dispatch with the batch padded to a power of two.  Padded batch
        rows address only the scratch row; padded positions write junk KV
        into slots rewritten before they are read, or past the table
        (dropped).  Group boundaries of a pure-offline plan are safepoints:
        KV writes are positional and idempotent, so an aborted iteration
        re-executes its chunks and rewrites the same bytes.  Returns True
        if the iteration aborted at such a safepoint."""
        groups: Dict[int, List] = {}
        for chunk in plan.prefill_chunks:
            groups.setdefault(self._chunk_bucket(chunk.length), []).append(chunk)
        cap = max(1, self.ec.max_prefill_batch)
        waves = []
        for lpad in sorted(groups):
            g = groups[lpad]
            waves += [(lpad, g[i : i + cap]) for i in range(0, len(g), cap)]
        for gi, (lpad, chunks) in enumerate(waves):
            if preemptible and gi > 0:
                t0 = time.perf_counter()
                self._on_safepoint(gi)
                hit = self.flag.is_set()
                st = self.safepoints.stats
                st.checks += 1
                st.check_seconds += time.perf_counter() - t0
                if hit:
                    st.preemptions += 1
                    self.flag.clear()
                    return True
            bp = pow2_bucket(len(chunks))
            toks = np.zeros((bp, lpad), np.int32)
            tables = np.full((bp, self._table_width), self._scratch_block, np.int32)
            offs = np.zeros((bp,), np.int32)
            last = np.zeros((bp,), np.int32)
            for i, c in enumerate(chunks):
                toks[i, : c.length] = self._tokens_of(c.request)[
                    c.offset : c.offset + c.length
                ]
                tables[i] = self._block_table(c.request.request_id)
                offs[i] = c.offset
                last[i] = c.length - 1
            self.dispatches["prefill"] += 1
            logits, _ = tf.prefill_chunk_paged(
                self.cfg, self.params, self._put(toks), self.pools,
                self._put(tables), self._put(offs), self._put(last),
            )
            done = [
                i for i, c in enumerate(chunks)
                if c.offset + c.length == c.request.kv_target
                and c.request.num_generated == 0
            ]
            if done:
                rows = torch.tensor(done, device=self.device)
                self._sample(logits[rows], [chunks[i].request for i in done], tokens)
        return False

    def _decode_paged(self, reqs: List[Request], use_safepoints: bool):
        """Batched decode on the shared pool at a power-of-two batch
        bucket; padded rows address only the scratch row.  Returns
        ``(logits (len(reqs), V) | None, aborted)``."""
        bsz = len(reqs)
        bp = pow2_bucket(bsz)
        tables = np.full((bp, self._table_width), self._scratch_block, np.int32)
        last = np.zeros((bp,), np.int32)
        lens = np.zeros((bp,), np.int32)
        for i, r in enumerate(reqs):
            tables[i] = self._block_table(r.request_id)
            last[i] = self._tokens_of(r)[-1]
            lens[i] = r.total_len - 1
        last_t, tables_t, lens_t = self._put(last), self._put(tables), self._put(lens)
        if use_safepoints:
            logits, aborted = self._segmented_decode_paged(last_t, tables_t, lens_t)
            if aborted:
                return None, True
        else:
            self.dispatches["decode"] += 1
            logits, _ = tf.decode_step_paged(
                self.cfg, self.params, last_t, self.pools, tables_t, lens_t
            )
        return logits[:bsz], False

    def _segmented_decode_paged(self, last, tables, positions_1d):
        """Safepoint-instrumented paged decode: one dispatch per K-layer
        segment, flag check between them (§4.3).  Pool writes of an aborted
        attempt sit at the uncommitted position and are rewritten verbatim
        on re-execution."""
        x = tf.embed(self.cfg, self.params, last[:, None])
        positions = positions_1d[:, None]

        def seg(lo, pps, h):
            h, _ = tf.run_segment_paged_at(
                self.cfg, self.params, pps, lo, h, self.pools, tables, positions
            )
            return h

        x, aborted = self._run_segments(x, seg, "segment", True)
        if aborted:
            return None, True
        return tf.lm_head(self.cfg, self.params, x)[:, 0, :], False

    # ------------------------------------------------ contiguous fallback
    def _prefill_contiguous(self, plan, tokens: Dict[int, int]) -> None:
        """Per-request prefill chunks on the contiguous layout: one
        ``prefill_chunk`` dispatch per chunk, against the request's cache."""
        for chunk in plan.prefill_chunks:
            r = chunk.request
            rid = r.request_id
            if not self.cfg.causal:
                # the reference runs an encoder job as one forward_full
                raise NotImplementedError(
                    f"encoder prefill is not ported yet ({tf.ARCHS_ITEM})"
                )
            toks = self._tokens_of(r)[chunk.offset : chunk.offset + chunk.length]
            if rid not in self.caches:
                self.caches[rid] = self._fresh_cache(r)
            self.dispatches["prefill"] += 1
            logits, _ = tf.prefill_chunk(
                self.cfg, self.params, self._put(toks[None]), self.caches[rid],
                [chunk.offset],
            )
            if chunk.offset + chunk.length == r.kv_target and r.num_generated == 0:
                self._sample(logits, [r], tokens)

    def _decode_contiguous(self, reqs: List[Request], use_safepoints: bool):
        """One decode batch over the requests' caches: concatenated into one
        batch (a copy), run in place, then sliced back (views of the batch).
        An aborted attempt leaves the requests' own caches untouched.
        Returns ``(logits (len(reqs), V) | None, aborted)``."""
        first = self.caches[reqs[0].request_id]
        stacked = {
            pos: {name: torch.cat([self.caches[r.request_id][pos][name] for r in reqs], dim=1)
                  for name in first[pos]}
            for pos in first
        }
        last = self._put(np.asarray([self._tokens_of(r)[-1] for r in reqs], np.int32))
        lens = self._put(np.asarray([r.total_len - 1 for r in reqs], np.int32))
        if use_safepoints:
            logits, aborted = self._segmented_decode(stacked, last, lens)
            if aborted:
                return None, True
        else:
            self.dispatches["decode"] += 1
            logits, _ = tf.decode_step(self.cfg, self.params, last, stacked, lens)
        for i, r in enumerate(reqs):
            self.caches[r.request_id] = {
                pos: {name: leaf[:, i : i + 1] for name, leaf in c.items()}
                for pos, c in stacked.items()
            }
        return logits, False

    def _segmented_decode(self, stacked, last, lens):
        """Safepoint-instrumented contiguous decode: one dispatch per
        K-layer segment, flag check between them (§4.3)."""
        x = tf.embed(self.cfg, self.params, last[:, None])
        positions = lens[:, None]
        seg_of = {lo: i for i, (lo, _pps) in enumerate(tf.segment_spans(self.cfg))}

        def seg(lo, _pps, h):
            h, _ = tf.run_segment(self.cfg, self.params, seg_of[lo], h, stacked,
                                  mode="decode", positions=positions)
            return h

        x, aborted = self._run_segments(x, seg, "segment", True)
        if aborted:
            return None, True
        return tf.lm_head(self.cfg, self.params, x)[:, 0, :], False

    # ----------------------------------------------------------- calibration
    def calibrate(self, grid: Optional[CalibrationGrid] = None) -> MeasuredProfiler:
        """On-device calibration pass (DESIGN.md §10).

        Times the engine's own dispatches over the shapes serving runs --
        on the fused path fused ragged dispatches (pure prefill, pure
        decode, and mixed chunk + decode points at
        ``CalibrationGrid.token_buckets``); on the split path bucketed
        prefill groups and decode batches; on the contiguous path
        one-sequence prefill chunks and decode batches -- fits a ``MeasuredProfiler``
        and installs it as the scheduler's latency model, so token budgets
        come from measured time on this card instead of the analytical
        prior.  Each probe is timed on the host clock around the dispatch
        and a device synchronisation: the scheduler budgets wall time, and
        the host's share of a step counts.  Probes address only the scratch
        row (paged) or throwaway caches allocated per call (contiguous, as
        in the reference: its decode times include that allocation), so
        calibration never perturbs live KV."""
        if grid is None:
            grid = self._default_grid()
        if grid.pipeline_depth != 1:
            raise NotImplementedError(
                "pipelined calibration needs the async pipeline, not ported "
                "yet (ROADMAP Queue 1: the async pipeline)"
            )
        dev = self.device
        max_ctx = self.ec.max_model_len
        scratch = self._scratch_block

        def run(fn) -> None:
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def timed(fn) -> float:
            for _ in range(grid.warmup):
                run(fn)
            best = float("inf")
            for _ in range(grid.repeats):
                t0 = time.perf_counter()
                run(fn)
                best = min(best, time.perf_counter() - t0)
            return best

        fused_timer = None
        if self.fused:
            def probe(items) -> Callable[[], Any]:
                toks, tables, positions, meta, li = self._fused_inputs(
                    self._build_ragged(items)
                )

                def once():
                    x = tf.embed(self.cfg, self.params, toks[None])
                    for lo, pps in tf.segment_spans(self.cfg):
                        x, _ = tf.run_tokens_paged_at(
                            self.cfg, self.params, pps, lo, x, self.pools,
                            tables, positions, meta,
                        )
                    return tf.ragged_lm_head(self.cfg, self.params, x, li)

                return once

            def prefill_timer(b: int, c: int) -> float:
                b, c = pow2_bucket(b), self._chunk_bucket(min(c, max_ctx))
                return timed(probe([(c, 0, None, None)] * b))

            def decode_timer(b: int, ctx: int) -> float:
                ctx = max(1, min(ctx, max_ctx - 1))
                return timed(probe([(1, ctx, None, None)] * b))

            def fused_timer(tok: int, kv: int):
                c = min(self.sched.sc.chunk_size, max_ctx, tok)
                # decode rows fill the token bucket, but never past the
                # sequence count a real plan can hold
                ndec = max(0, min(tok - c, self.sched.sc.max_batch_seqs - 1))
                items = [(c, 0, None, None)] + [(1, kv, None, None)] * ndec
                shape = BatchShape(
                    prefill_tokens=c, prefill_attn_tokens=c * c / 2.0,
                    prefill_ctx_end=c, decode_tokens=ndec,
                    decode_ctx=ndec * kv, num_seqs=1 + ndec,
                )
                return shape, timed(probe(items))
        elif not self.paged:
            def prefill_timer(b: int, c: int) -> float:
                del b  # contiguous prefill is one sequence per dispatch
                toks = self._put(np.zeros((1, c), np.int32))
                return timed(lambda: tf.prefill_chunk(
                    self.cfg, self.params, toks,
                    tf.init_caches(self.cfg, 1, max_ctx, self.dtype, dev), [0]))

            def decode_timer(b: int, ctx: int) -> float:
                last = self._put(np.zeros((b,), np.int32))
                lens = self._put(np.full((b,), min(ctx, max_ctx - 1), np.int32))
                return timed(lambda: tf.decode_step(
                    self.cfg, self.params, last,
                    tf.init_caches(self.cfg, b, max_ctx, self.dtype, dev), lens))
        else:
            width = self._table_width

            def prefill_timer(b: int, c: int) -> float:
                b, c = pow2_bucket(b), self._chunk_bucket(c)
                toks = self._put(np.zeros((b, c), np.int32))
                tables = self._put(np.full((b, width), scratch, np.int32))
                offs = self._put(np.zeros((b,), np.int32))
                last = self._put(np.full((b,), c - 1, np.int32))
                return timed(lambda: tf.prefill_chunk_paged(
                    self.cfg, self.params, toks, self.pools, tables, offs, last))

            def decode_timer(b: int, ctx: int) -> float:
                last = self._put(np.zeros((b,), np.int32))
                tables = self._put(np.full((b, width), scratch, np.int32))
                lens = self._put(np.full((b,), min(ctx, max_ctx - 1), np.int32))
                return timed(lambda: tf.decode_step_paged(
                    self.cfg, self.params, last, self.pools, tables, lens))

        def swap_timer(n: int):
            nbytes = n * block_bytes(self.cfg, self.ec.block_size)
            return nbytes, timed(lambda: self._extract_blocks_paged([scratch] * n))

        if not self.paged:
            swap_timer = None  # as in the reference: no swap probes

        prof = calibrate(prefill_timer, decode_timer, max_ctx, grid, swap_timer,
                         fused_timer=fused_timer)
        self.profile = prof
        self.sched.model = prof
        self.sched._sat_cache = None  # the saturation knee derives from the model
        return prof

    def _default_grid(self) -> CalibrationGrid:
        """Every shape bucket serving can dispatch: chunk buckets 8..chunk
        size, decode batch buckets up to ``max_batch_seqs``, prefill group
        buckets up to ``max_prefill_batch``, and on the fused path mixed
        points at the two token buckets past one chunk."""
        top = self._chunk_bucket(min(self.sched.sc.chunk_size, self.ec.max_model_len))

        def pow2s(hi):
            out, v = [], 1
            while v <= hi:
                out.append(v)
                v *= 2
            return tuple(out)

        chunks = tuple(c for c in pow2s(top) if c >= 8)
        tok0 = pow2_bucket(top + 1)
        return CalibrationGrid(
            chunk_sizes=chunks,
            # contiguous prefill is one sequence per dispatch
            prefill_batches=(pow2s(pow2_bucket(max(1, self.ec.max_prefill_batch)))
                             if self.paged else (1,)),
            decode_buckets=pow2s(pow2_bucket(self.sched.sc.max_batch_seqs)),
            token_buckets=(tok0, 2 * tok0) if self.fused else (),
        )

    def run(self, max_steps: Optional[int] = None) -> None:
        limit = max_steps or self.ec.max_steps
        for _ in range(limit):
            if not self.step():
                break
