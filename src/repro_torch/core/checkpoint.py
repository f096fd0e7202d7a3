"""Incremental KV checkpointing (§4.4): adaptive policy + background I/O.

Three pieces:

* ``AdaptiveCheckpointPolicy`` — RED-inspired ramp: start checkpointing when
  device memory crosses ``start_threshold`` (default 50%, as in the paper),
  ramp the per-iteration rate with memory pressure and with the observed KV
  consumption rate, so checkpointing speed tracks allocation speed.
* ``Checkpointer`` — the paper's two-interface design:
  ``mark(seqs)`` (= checkpoint(seqs)) registers executed offline sequences as
  candidates after each step; ``plan(...)`` (= get_blocks_to_chkpt()) applies
  the policy right before the next schedule and returns concrete
  (seq, block_index) pairs.  Only *complete* blocks are checkpointed — the
  per-iteration delta is bounded by one token per sequence.
* ``HostIOTracker`` — models the device↔host link as a drainable backlog:
  checkpoint and prefetch bytes drain at ``host_bw`` *in the background*
  (overlapped with compute); the SLO-aware cap simply refuses to enqueue
  more than one iteration's worth of drain, deferring the rest (paper:
  "defers the extra blocks to the next round").  Swap-ins complete
  asynchronously; a resumed sequence becomes decodable once its bytes drain.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.kvcache.block_manager import BlockManager, OutOfBlocks

from .request import Request

# ---------------------------------------------------------------------------


@dataclass
class AdaptiveCheckpointPolicy:
    start_threshold: float = 0.5  # paper default: begin at 50% memory use
    min_blocks: int = 1
    max_blocks_per_iter: int = 64
    ema_alpha: float = 0.3

    _consumption_ema: float = 0.0  # blocks/iteration being newly consumed
    _last_used: Optional[int] = None

    def observe(self, used_blocks: int) -> None:
        if self._last_used is not None:
            delta = max(0, used_blocks - self._last_used)
            self._consumption_ema = (
                self.ema_alpha * delta + (1 - self.ema_alpha) * self._consumption_ema
            )
        self._last_used = used_blocks

    def blocks_this_iter(self, utilization: float, candidates: int) -> int:
        """How many candidate blocks to checkpoint this iteration."""
        if candidates <= 0 or utilization < self.start_threshold:
            return 0
        # Ramp 0->1 across [threshold, 1.0]; scale to match (and slightly
        # outpace) the consumption rate so host copies keep up (RED-style).
        ramp = (utilization - self.start_threshold) / max(
            1e-9, 1.0 - self.start_threshold
        )
        target = max(
            self.min_blocks,
            int(round((1.0 + ramp) * max(1.0, self._consumption_ema))),
        )
        burst = int(round(ramp * self.max_blocks_per_iter))
        return min(candidates, max(target, burst, self.min_blocks))


# ---------------------------------------------------------------------------


@dataclass
class CheckpointStats:
    blocks_checkpointed: int = 0
    bytes_checkpointed: int = 0
    blocks_prefetched: int = 0
    bytes_prefetched: int = 0
    free_discards: int = 0  # preemptions that cost zero I/O thanks to IC
    blocking_swap_outs: int = 0
    # checkpoints of blocks with refcount > 1 (prefix sharing, §14): safe
    # because a shared full block is immutable — any divergent writer is
    # rerouted to a private copy by the COW barrier before its write lands
    shared_block_checkpoints: int = 0
    # rounds cut short by host-pool exhaustion past the free-count pre-cap
    # (injected host.checkpoint faults): checkpointing is best-effort, so
    # the rest of the round is simply deferred (DESIGN.md §16)
    host_pool_skips: int = 0


class Checkpointer:
    """checkpoint(seqs) / get_blocks_to_chkpt() (paper §5)."""

    def __init__(
        self,
        blocks: BlockManager,
        policy: AdaptiveCheckpointPolicy,
        bytes_per_block: int,
        enabled: bool = True,
    ):
        self.blocks = blocks
        self.policy = policy
        self.bytes_per_block = bytes_per_block
        self.enabled = enabled
        self._candidates: Dict[int, Request] = {}  # seq_id -> request (ordered)
        self.stats = CheckpointStats()

    # -- checkpoint(seqs: List[Sequence]) ----------------------------------
    def mark(self, reqs: List[Request]) -> None:
        if not self.enabled:
            return
        for r in reqs:
            if not r.is_online and self.blocks.has_seq(r.request_id):
                self._candidates[r.request_id] = r

    def unmark(self, req: Request) -> None:
        self._candidates.pop(req.request_id, None)

    # -- get_blocks_to_chkpt() -> List[KVBlock] ------------------------------
    def plan(self, io_budget_blocks: int) -> List[Tuple[int, int, int, int]]:
        """Select blocks to checkpoint now.

        Returns [(seq_id, block_index, device_block, host_block)] with host
        blocks already reserved; the engine performs the copies (or the sim
        accounts their bytes).
        """
        if not self.enabled:
            return []
        util = self.blocks.device_utilization
        self.policy.observe(self.blocks.used_device_blocks)
        total = 0
        pending: List[Tuple[int, int]] = []  # (seq_id, block_index)
        for seq_id in list(self._candidates):
            if not self.blocks.has_seq(seq_id) or not self.blocks.seq(seq_id).on_device:
                del self._candidates[seq_id]
                continue
            r = self._candidates[seq_id]
            # tokens whose KV is on device: the prefill extent, or (prefill
            # done) every token but the last generated one
            written = r.kv_target if r.prefill_remaining == 0 else r.num_prefilled
            cands = self.blocks.checkpoint_candidates(seq_id, written)
            for idx, _dev in cands:
                pending.append((seq_id, idx))
            if not cands and self.blocks.is_fully_checkpointed(seq_id):
                del self._candidates[seq_id]
        n = self.policy.blocks_this_iter(util, len(pending))
        n = min(n, io_budget_blocks, self.blocks.free_host_blocks)
        out = []
        for seq_id, idx in pending[:n]:
            try:
                dev, host = self.blocks.assign_checkpoint(seq_id, idx)
            except OutOfBlocks:
                # host pool exhausted past the pre-cap: checkpointing is
                # best-effort — defer the rest of this round, never raise
                self.stats.host_pool_skips += 1
                break
            if self.blocks.block_refcount(dev) > 1:
                # Sharing rule (DESIGN.md §14): checkpointing a shared block
                # is sound — shared full blocks are immutable under COW — and
                # each sharer keeps a *private* host copy, so one sequence's
                # later divergence (which releases only its own checkpoint)
                # can never invalidate another's restore path.
                self.stats.shared_block_checkpoints += 1
            out.append((seq_id, idx, dev, host))
            total += 1
        self.stats.blocks_checkpointed += total
        self.stats.bytes_checkpointed += total * self.bytes_per_block
        return out


# ---------------------------------------------------------------------------


class HostKVStore:
    """Host-memory staging store for checkpointed / swapped-out KV blocks.

    Keyed by (seq_id, block_index): the logical identity of a block within
    its sequence.  The *physical* ids (device block for the pool copy, host
    block from the BlockManager's table) stay in the manager's accounting —
    this store only holds the bytes, so restores are O(block) pool writes
    keyed by whatever physical block the resume re-allocated (§4.4).
    """

    def __init__(self):
        self._blocks: Dict[Tuple[int, int], object] = {}
        self.bytes_stored = 0

    @staticmethod
    def _nbytes(block) -> int:
        """Bytes of a stored block: the sum of ``nbytes`` over the leaves
        (torch tensors or numpy arrays) of its nested dicts."""
        if isinstance(block, dict):
            return sum(HostKVStore._nbytes(v) for v in block.values())
        return int(getattr(block, "nbytes", 0))

    def put(self, seq_id: int, block_index: int, block) -> None:
        self.pop(seq_id, block_index)
        self._blocks[(seq_id, block_index)] = block
        self.bytes_stored += self._nbytes(block)

    def get(self, seq_id: int, block_index: int):
        return self._blocks.get((seq_id, block_index))

    def pop(self, seq_id: int, block_index: int) -> None:
        old = self._blocks.pop((seq_id, block_index), None)
        if old is not None:
            self.bytes_stored -= self._nbytes(old)

    def drop_seq(self, seq_id: int) -> None:
        for key in [k for k in self._blocks if k[0] == seq_id]:
            self.pop(*key)

    def seq_ids(self):
        return {k[0] for k in self._blocks}

    def __len__(self) -> int:
        return len(self._blocks)


# ---------------------------------------------------------------------------


@dataclass
class HostIOTracker:
    """Backlog model of the device↔host link for background I/O.

    All times are engine-clock seconds.  The link drains FIFO at host_bw;
    ``ready_at`` answers when a given enqueued transfer completes.
    """

    host_bw: float  # bytes/s
    backlog_bytes: float = 0.0
    last_time: float = 0.0

    def _drain(self, now: float) -> None:
        elapsed = max(0.0, now - self.last_time)
        self.backlog_bytes = max(0.0, self.backlog_bytes - elapsed * self.host_bw)
        self.last_time = now

    def enqueue(self, now: float, n_bytes: float) -> float:
        """Enqueue a background transfer; returns its completion time."""
        self._drain(now)
        self.backlog_bytes += n_bytes
        return now + self.backlog_bytes / self.host_bw

    def budget_blocks(self, now: float, window: float, bytes_per_block: int) -> int:
        """SLO-aware cap: blocks whose transfer fits in the next ``window``
        seconds of link time given the current backlog."""
        self._drain(now)
        spare = max(0.0, window * self.host_bw - self.backlog_bytes)
        return int(spare // max(1, bytes_per_block))
