"""Real-execution co-serving engine in PyTorch: the ConServe policies
(UnifiedScheduler / Checkpointer / safepoints) driving the port's model on
a CUDA card (or the CPU, when the caller asks for it).

Counterpart of ``src/repro/serving/real_engine.py`` restricted to its
default hot path: the paged KV pool, the fused ragged batch
(``fused_batch=True``), the serial engine (``pipeline=False``) and a single
device (``mesh=None``).  Any other setting raises ``NotImplementedError``
naming the ROADMAP item that brings it.

* Physical KV layout: shared pools ``(num_periods, num_device_blocks + 1,
  block_size, Hkv, D)`` per pattern position, updated in place; the last
  row is a scratch block that absorbs writes from padded tokens.
* Every iteration lowers the whole ``IterationPlan`` (online decodes plus
  offline prefill chunks) to ONE flattened ragged token batch
  (``_build_ragged``), padded to power-of-two (T, S, Qmax) buckets, and runs
  it one K-layer segment at a time with safepoint checks between segments.
  Each layer scatters the new KV and runs the ragged paged-attention kernel
  once.
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
from ..core.profiler import AnalyticalCostModel, block_bytes, h100_spec
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
    no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
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
    # "auto" or "paged": the fused paged path; "contiguous" is not ported
    backend: str = "auto"
    # The settings below exist for parity with the reference; only their
    # defaults run in the port.
    fused_batch: bool = True
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
        if eng_cfg.backend == "contiguous" or not tf.supports_paged(cfg):
            raise NotImplementedError(
                "the contiguous fallback is not ported yet (ROADMAP Queue 1 "
                "item 9)"
            )
        if not eng_cfg.fused_batch:
            raise NotImplementedError(
                "the split fused_batch=False paths are not ported yet (ROADMAP "
                "Queue 1 item 7)"
            )
        if eng_cfg.pipeline:
            raise NotImplementedError(
                "the async pipeline is not ported yet (ROADMAP Queue 1 item 6)"
            )
        if eng_cfg.mesh is not None:
            raise NotImplementedError(
                "tensor-parallel serving is not ported yet (ROADMAP Queue 1 "
                "item 8)"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = to_device(params, self.device)
        self.dtype = self.params["embed"].dtype
        self.ec = eng_cfg
        self.sampling = sampling
        self._clock = clock or time.perf_counter

        self.blocks = BlockManager(
            eng_cfg.num_device_blocks, eng_cfg.num_host_blocks,
            eng_cfg.block_size, prefix_cache=eng_cfg.prefix_cache,
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
        self.dispatches: Dict[str, int] = {"fused_segment": 0, "fused_logits": 0}
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
        self.measured_iter_seconds = 0.0
        self.predicted_iter_seconds = 0.0
        self.measured_iters = 0

        self._scratch_block = eng_cfg.num_device_blocks
        self._table_width = self.blocks.blocks_for_tokens(eng_cfg.max_model_len)
        self.pools = tf.init_paged_pools(
            cfg, eng_cfg.num_device_blocks + 1, eng_cfg.block_size,
            dtype=self.dtype, device=self.device,
        )

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

    def calibrate(self, *a, **k):
        raise NotImplementedError(
            "calibration is not ported yet (ROADMAP Queue 1 item 5)"
        )

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

    # ---------------------------------------------------------------- events
    def _process_events(self) -> None:
        for kind, req, payload in self.sched.events:
            rid = req.request_id
            if kind in ("preempt_discard", "preempt_swap"):
                if kind == "preempt_swap" and payload:
                    # blocking swap-out of the un-checkpointed blocks
                    stored = self._extract_blocks_paged(
                        [dev for _idx, dev, _host in payload]
                    )
                    for (idx, _dev, _host), blk in zip(payload, stored):
                        self.host.put(rid, idx, blk)
                self.ckpt.unmark(req)  # discard: pure table edits (§4.4)
            elif kind == "cow":
                # duplicate shared blocks before this iteration's writes land
                # in them; host bytes of the re-written indices are stale
                if payload:
                    self._cow_blocks_paged(payload)
                for idx, _src, _dst in payload:
                    self.host.pop(rid, idx)
            elif kind == "resume":
                nrec = self.blocks.blocks_for_tokens(req.host_recoverable)
                sb = self.blocks.seq(rid)
                devs, blks = [], []
                for b in range(nrec):
                    stored = self.host.get(rid, b)
                    if stored is not None:
                        devs.append(sb.device_blocks[b])
                        blks.append(stored)
                if devs:
                    self._restore_blocks_paged(devs, blks)
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
        aborted = self._run_fused(plan, preemptible, tokens)

        sched.commit(plan, self._clock(), aborted=aborted, tokens=tokens)
        self._step_snap = None
        self.measured_iter_seconds += time.perf_counter() - t_iter0
        self.predicted_iter_seconds += predicted_s
        self.measured_iters += 1
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
        stored = self._extract_blocks_paged([c[2] for c in chosen])
        for (seq_id, idx, _dev, _host), blk in zip(chosen, stored):
            self.host.put(seq_id, idx, blk)

    # ------------------------------------------------- fused ragged execution
    def _build_ragged(self, items: List[tuple]) -> Dict[str, np.ndarray]:
        """Lower one iteration's sequences to flat ragged-batch arrays.

        ``items`` holds one ``(q_len, ctx_start, tokens, table)`` per
        sequence.  T (total tokens), S (sequences) and Qmax (longest query
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
            a["tokens"][sl] = toks
            a["positions"][sl] = pos
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
            sel = logits[rows]
            toks = sample(sel, self.sampling, self._gen).cpu().numpy()
            if self.margins is not None:
                top2 = torch.topk(sel, 2, dim=-1).values.cpu().numpy()
                for (_, r), (a, b) in zip(samplers, top2):
                    self.margins.setdefault(r.request_id, []).append(
                        float(a - b)
                    )
            for (_, r), t in zip(samplers, toks):
                tokens[r.request_id] = int(t)
            self._last_event = None  # the readback above drained the device
        elif self.device.type == "cuda":
            self._last_event = torch.cuda.Event()
            self._last_event.record()
        self._t_last_enqueue = time.perf_counter()
        return False

    def run(self, max_steps: Optional[int] = None) -> None:
        limit = max_steps or self.ec.max_steps
        for _ in range(limit):
            if not self.step():
                break
