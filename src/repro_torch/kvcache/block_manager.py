"""Paged KV-cache block manager (vLLM-style) with ConServe's checkpoint map.

Host-side bookkeeping: which physical device blocks belong to which sequence,
which device block has a host-memory checkpoint copy (the paper's "extended
field of the virtual page table", §5), and which sequences live only in host
memory (preempted-with-checkpoint).

Device data movement is *not* done here — the engine issues copies; this
class is the single source of truth for what must move and what can be
discarded for free.  ConServe's key property: discarding a fully
checkpointed sequence costs zero device I/O (just table edits), while an
un-checkpointed preemption forces either a blocking swap-out or a recompute.

With ``prefix_cache=True`` the manager additionally keeps per-block
refcounts and a content-hash index over *full* blocks, keyed by the
token-id chain that produced them (DESIGN.md §14).  A new sequence whose
prompt shares a prefix with an indexed chain maps those pool blocks into
its own table (refcount bump, zero device I/O); the first write into a
shared block triggers copy-on-write via :meth:`prepare_write`.  Blocks
whose refcount drops to zero but that still carry an index entry park in a
"cached-free" pool: they count as free capacity and are lazily evicted
(oldest first) when the allocator runs dry, so repeated corpora keep
hitting warm KV for as long as memory allows.

Terminology (all integers are block ids):
  device block — slot in the preallocated device KV pool
  host block   — slot in the host staging pool
"""
from __future__ import annotations

import hashlib
import math
from collections import Counter, OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np


class OutOfBlocks(Exception):
    pass


def chain_keys(tokens: Sequence[int], block_size: int) -> List[bytes]:
    """Content-hash chain over the full blocks of a token sequence.

    ``keys[i]`` digests tokens ``[0, (i+1)*block_size)`` — each link hashes
    the previous digest plus the block's token ids, so a key identifies the
    whole prefix, not just one block's tokens.  Two sequences share
    ``keys[i]`` iff their first ``(i+1)*block_size`` token ids are equal,
    which (with deterministic kernels) is exactly when their KV for those
    positions is bitwise interchangeable.
    """
    keys: List[bytes] = []
    prev = b""
    for i in range(len(tokens) // block_size):
        h = hashlib.sha256(prev)
        h.update(
            np.asarray(
                tokens[i * block_size:(i + 1) * block_size], np.int64
            ).tobytes()
        )
        prev = h.digest()
        keys.append(prev)
    return keys


@dataclass
class SeqBlocks:
    """Block state of one sequence."""

    seq_id: int
    num_tokens: int = 0
    device_blocks: List[int] = field(default_factory=list)
    host_blocks: List[int] = field(default_factory=list)  # parallel: -1 = none
    on_device: bool = True  # False once swapped out / preempted-to-host
    num_cached: int = 0  # tokens satisfied from the prefix index at register
    prefix_keys: List[bytes] = field(default_factory=list)

    def num_full_or_partial_blocks(self, block_size: int) -> int:
        return math.ceil(self.num_tokens / block_size) if self.num_tokens else 0

    @property
    def num_checkpointed(self) -> int:
        return sum(1 for h in self.host_blocks if h >= 0)


class BlockManager:
    def __init__(
        self,
        num_device_blocks: int,
        num_host_blocks: int,
        block_size: int,
        prefix_cache: bool = False,
    ):
        if num_device_blocks <= 0 or block_size <= 0:
            raise ValueError("pool sizes must be positive")
        self.block_size = block_size
        self.num_device_blocks = num_device_blocks
        self.num_host_blocks = num_host_blocks
        self.prefix_cache = prefix_cache
        self._free_device: List[int] = list(range(num_device_blocks - 1, -1, -1))
        self._free_host: List[int] = list(range(num_host_blocks - 1, -1, -1))
        self._seqs: Dict[int, SeqBlocks] = {}
        # --- sharing state (live even with prefix_cache=False: refcounts
        # are then all 0/1 and the index stays empty) ---
        self._ref: List[int] = [0] * num_device_blocks
        self._index: Dict[bytes, int] = {}  # chain key -> device block
        self._key_of_block: Dict[int, bytes] = {}  # inverse of _index
        # ref==0 blocks still carrying an index entry, oldest first
        self._cached_free: "OrderedDict[int, None]" = OrderedDict()
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0
        self.cow_copies = 0
        # Optional core.faults.FaultInjector (DESIGN.md §16).  Each pool
        # mutation with an OutOfBlocks contract arms a named point *before*
        # mutating, so an injected exhaustion is indistinguishable from the
        # real thing (atomicity preserved) and must be absorbed by the same
        # caller-side degradation path.
        self.faults = None

    def _maybe_fault(self, point: str, detail: str) -> None:
        if self.faults is not None and self.faults.fires(point):
            raise OutOfBlocks(f"injected fault [{point}]: {detail}")

    # ------------------------------------------------------------------ info
    @property
    def free_device_blocks(self) -> int:
        """Allocatable capacity: plain-free plus cached-free (evictable)."""
        return len(self._free_device) + len(self._cached_free)

    @property
    def used_device_blocks(self) -> int:
        return self.num_device_blocks - self.free_device_blocks

    @property
    def cached_free_blocks(self) -> int:
        return len(self._cached_free)

    @property
    def free_host_blocks(self) -> int:
        return len(self._free_host)

    @property
    def device_utilization(self) -> float:
        return self.used_device_blocks / self.num_device_blocks

    def seq(self, seq_id: int) -> SeqBlocks:
        return self._seqs[seq_id]

    def has_seq(self, seq_id: int) -> bool:
        return seq_id in self._seqs

    def seq_ids(self) -> List[int]:
        return list(self._seqs)

    def block_refcount(self, device_block: int) -> int:
        return self._ref[device_block]

    def blocks_for_tokens(self, num_tokens: int) -> int:
        return math.ceil(num_tokens / self.block_size) if num_tokens else 0

    def block_table(self, seq_id: int, width: int, pad: int = -1) -> List[int]:
        """Physical device-block table row for a resident sequence, padded
        to ``width`` entries — the addressing row the paged attention
        kernels consume."""
        sb = self._seqs[seq_id]
        if len(sb.device_blocks) > width:
            raise ValueError(
                f"seq {seq_id}: {len(sb.device_blocks)} blocks exceed table "
                f"width {width}"
            )
        return sb.device_blocks + [pad] * (width - len(sb.device_blocks))

    def can_allocate(self, seq_id: int, new_total_tokens: int) -> bool:
        cur = self._seqs.get(seq_id)
        have = len(cur.device_blocks) if cur and cur.on_device else 0
        need = self.blocks_for_tokens(new_total_tokens) - have
        return need <= self.free_device_blocks

    # ----------------------------------------------------- internal alloc/free
    def _alloc_block(self) -> int:
        """Pop a free block, lazily evicting the oldest cached-free block
        (dropping its index entry) when the plain-free list runs dry.
        Callers must pre-check ``free_device_blocks`` for atomicity."""
        if self._free_device:
            return self._free_device.pop()
        if self._cached_free:
            b, _ = self._cached_free.popitem(last=False)
            del self._index[self._key_of_block.pop(b)]
            return b
        raise OutOfBlocks("device pool exhausted")

    def _ref_block(self, b: int) -> None:
        """Take a reference on ``b`` — resurrects it from cached-free."""
        if self._ref[b] == 0 and b in self._cached_free:
            del self._cached_free[b]
        self._ref[b] += 1

    def _unref_block(self, b: int) -> None:
        """Drop one reference; at zero the block returns to the free pool —
        cached-free if it still backs an index entry, plain-free otherwise."""
        self._ref[b] -= 1
        assert self._ref[b] >= 0, f"refcount underflow on block {b}"
        if self._ref[b] == 0:
            if b in self._key_of_block:
                self._cached_free[b] = None
            else:
                self._free_device.append(b)

    # ------------------------------------------------------------------ alloc
    def register_seq(
        self, seq_id: int, tokens: Optional[Sequence[int]] = None
    ) -> SeqBlocks:
        """Register a sequence; with ``tokens`` (its prompt ids) and prefix
        caching on, map the longest indexed prefix chain onto existing pool
        blocks.  ``sb.num_cached`` tokens of KV are then already resident —
        the scheduler prefills only the suffix.  At least one prompt token
        is always left uncached so the first iteration has a query token to
        produce logits from (a fully cached prompt would emit nothing)."""
        if seq_id in self._seqs:
            raise ValueError(f"seq {seq_id} already registered")
        sb = SeqBlocks(seq_id=seq_id)
        if self.prefix_cache and tokens is not None and len(tokens) > 1:
            sb.prefix_keys = chain_keys(tokens, self.block_size)
            k = 0
            while k < len(sb.prefix_keys) and sb.prefix_keys[k] in self._index:
                k += 1
            if k > 0:
                # Cap at len-1: keep the final prompt token as the query.
                # When the whole prompt is indexed (k*bs == len) the last
                # mapped block takes the recompute of that token — the
                # canonical COW trigger.
                cached = min(k * self.block_size, len(tokens) - 1)
                for i in range(k):
                    b = self._index[sb.prefix_keys[i]]
                    self._ref_block(b)
                    sb.device_blocks.append(b)
                sb.host_blocks = [-1] * k
                sb.num_tokens = cached
                sb.num_cached = cached
                self.prefix_hits += 1
                self.prefix_tokens_saved += cached
        self._seqs[seq_id] = sb
        return sb

    def grow(self, seq_id: int, new_total_tokens: int) -> List[int]:
        """Extend a resident sequence to ``new_total_tokens``; returns the
        newly allocated device block ids."""
        sb = self._seqs[seq_id]
        if not sb.on_device:
            raise ValueError(f"seq {seq_id} is not resident")
        if new_total_tokens <= sb.num_tokens:
            return []  # capacity already covers (e.g. recompute after resume)
        need = self.blocks_for_tokens(new_total_tokens) - len(sb.device_blocks)
        if need > 0:
            self._maybe_fault("alloc.grow", f"grow seq {seq_id} by {need}")
        if need > self.free_device_blocks:
            raise OutOfBlocks(
                f"need {need} device blocks, have {self.free_device_blocks}"
            )
        new = [self._alloc_block() for _ in range(need)]
        for b in new:
            self._ref[b] += 1
        sb.device_blocks.extend(new)
        sb.host_blocks.extend([-1] * len(new))
        sb.num_tokens = new_total_tokens
        return new

    # --------------------------------------------------------------- sharing
    def prepare_write(
        self, seq_id: int, lo: int, hi: int
    ) -> List[Tuple[int, int, int]]:
        """Copy-on-write barrier for an imminent KV write to token positions
        ``[lo, hi)``: every *shared* block (refcount > 1) overlapping the
        range is swapped for a fresh exclusive copy in the seq's table.
        Returns ``(block_index, src_block, dst_block)`` triples — the engine
        must copy src→dst on device *before* the write dispatches.  Blocks
        the seq owns exclusively pass through untouched (rewriting an
        indexed block with its own chain's tokens keeps the index truthful).
        Atomic: raises OutOfBlocks without mutating if the pool cannot
        supply the copies."""
        sb = self._seqs[seq_id]
        if hi <= lo:
            return []
        if not sb.on_device:
            raise ValueError(f"seq {seq_id} is not resident")
        first = lo // self.block_size
        last = min((hi - 1) // self.block_size, len(sb.device_blocks) - 1)
        shared = [
            i for i in range(first, last + 1)
            if self._ref[sb.device_blocks[i]] > 1
        ]
        if not shared:
            return []
        self._maybe_fault("cow.prepare", f"COW for seq {seq_id}")
        if len(shared) > self.free_device_blocks:
            raise OutOfBlocks(
                f"COW needs {len(shared)} device blocks, have "
                f"{self.free_device_blocks}"
            )
        pairs = []
        for i in shared:
            src = sb.device_blocks[i]
            dst = self._alloc_block()
            self._ref[dst] = 1
            self._unref_block(src)  # ref > 1, so src stays live for others
            sb.device_blocks[i] = dst
            # Any host checkpoint of this index predates the divergent
            # write — release it rather than risk a stale restore (§14).
            if i < len(sb.host_blocks) and sb.host_blocks[i] >= 0:
                self._free_host.append(sb.host_blocks[i])
                sb.host_blocks[i] = -1
            pairs.append((i, src, dst))
        self.cow_copies += len(pairs)
        return pairs

    def commit_prefix(self, seq_id: int, upto_tokens: int) -> None:
        """Publish the seq's full blocks covering ``[0, upto_tokens)`` into
        the content index.  Called only at iteration *commit* — speculative
        or aborted work must never become a cache source, since its blocks
        may be reclaimed without the index hearing about it."""
        if not self.prefix_cache:
            return
        sb = self._seqs.get(seq_id)
        if sb is None or not sb.prefix_keys or not sb.on_device:
            return
        full = min(
            upto_tokens // self.block_size,
            len(sb.prefix_keys),
            len(sb.device_blocks),
        )
        for i in range(full):
            key = sb.prefix_keys[i]
            b = sb.device_blocks[i]
            if key in self._index or b in self._key_of_block:
                continue
            self._index[key] = b
            self._key_of_block[b] = key

    # ------------------------------------------------------------ checkpoint
    def checkpoint_candidates(
        self, seq_id: int, written: Optional[int] = None
    ) -> List[Tuple[int, int]]:
        """(index, device_block) pairs of *complete* blocks lacking a host copy.

        Only complete blocks are checkpointed: a partial tail block would be
        re-written every iteration; the paper amortizes exactly one block per
        ``block_size`` generated tokens per sequence.  ``written`` caps the
        count at the tokens whose KV is on device: the allocation extent
        ``num_tokens`` also covers the slot of the token the next decode
        writes, and a block checkpointed before that slot is written would
        restore stale KV there.
        """
        sb = self._seqs[seq_id]
        tokens = sb.num_tokens if written is None else min(sb.num_tokens, written)
        full = tokens // self.block_size
        return [
            (i, sb.device_blocks[i])
            for i in range(min(full, len(sb.device_blocks)))
            if sb.host_blocks[i] < 0
        ]

    def assign_checkpoint(self, seq_id: int, block_index: int) -> Tuple[int, int]:
        """Reserve a host block for device block ``block_index`` of the seq.
        Returns (device_block, host_block) — the engine performs the copy."""
        sb = self._seqs[seq_id]
        if sb.host_blocks[block_index] >= 0:
            raise ValueError("block already checkpointed")
        self._maybe_fault("host.checkpoint", f"checkpoint seq {seq_id}")
        if not self._free_host:
            raise OutOfBlocks("host pool exhausted")
        hb = self._free_host.pop()
        sb.host_blocks[block_index] = hb
        return sb.device_blocks[block_index], hb

    def checkpoint_fraction(self, seq_id: int) -> float:
        sb = self._seqs[seq_id]
        full = max(1, sb.num_tokens // self.block_size)
        return min(1.0, sb.num_checkpointed / full)

    def is_fully_checkpointed(self, seq_id: int) -> bool:
        sb = self._seqs[seq_id]
        full = sb.num_tokens // self.block_size
        return all(h >= 0 for h in sb.host_blocks[:full])

    # ------------------------------------------------------------ preemption
    def preempt_discard(self, seq_id: int) -> Tuple[int, List[Tuple[int, int]]]:
        """Preempt by discard: drop the seq's references instantly.

        Blocks WITH host checkpoints survive (resume = swap-in); tokens in
        un-checkpointed blocks must be recomputed.  Under sharing a
        "discarded" block with refcount > 1 merely loses this seq's
        reference — other tables (and the content index) keep it live, so
        the discard stays free device-I/O-wise without invalidating anyone
        else's KV.  Returns (tokens_to_recompute, released (idx, block))."""
        sb = self._seqs[seq_id]
        freed = list(enumerate(sb.device_blocks))
        for b in sb.device_blocks:
            self._unref_block(b)
        # Tokens surviving in host memory: leading fully checkpointed prefix.
        surviving = 0
        full = sb.num_tokens // self.block_size
        for i in range(full):
            if sb.host_blocks[i] >= 0:
                surviving += self.block_size
            else:
                break
        # Host blocks beyond the contiguous prefix are useless — release them.
        keep = surviving // self.block_size
        for i, h in enumerate(sb.host_blocks):
            if i >= keep and h >= 0:
                self._free_host.append(h)
                sb.host_blocks[i] = -1
        recompute = sb.num_tokens - surviving
        sb.device_blocks = []
        sb.host_blocks = sb.host_blocks[:keep]
        sb.on_device = False
        return recompute, freed

    def swap_out_bytes_needed(self, seq_id: int, bytes_per_block: int) -> int:
        """Bytes a *blocking* swap-out would move (un-checkpointed complete
        blocks + the partial tail).  ConServe's IC drives this toward 0."""
        sb = self._seqs[seq_id]
        full = sb.num_tokens // self.block_size
        unck = sum(1 for h in sb.host_blocks[:full] if h < 0)
        partial = 1 if sb.num_tokens % self.block_size else 0
        return (unck + partial) * bytes_per_block

    def preempt_swap_out(self, seq_id: int) -> List[Tuple[int, int, int]]:
        """Preempt by full swap-out: every device block gets a host copy
        (reusing existing checkpoints), then the seq's references are
        dropped — a shared block survives on device for its other owners
        while this seq keeps its own private host bytes.
        Returns (block_index, device_block, host_block) copies the engine
        must perform — the index keys the engine's host store, the device
        id addresses the paged pool.
        Atomic: raises OutOfBlocks (without mutating) if the host pool
        cannot take the un-checkpointed blocks — callers fall back to
        discard, as vLLM does."""
        sb = self._seqs[seq_id]
        self._maybe_fault("host.swap_out", f"swap out seq {seq_id}")
        need = sum(1 for h in sb.host_blocks if h < 0)
        if need > len(self._free_host):
            raise OutOfBlocks("host pool exhausted during swap-out")
        copies = []
        for i, db in enumerate(sb.device_blocks):
            if sb.host_blocks[i] < 0:
                sb.host_blocks[i] = self._free_host.pop()
                copies.append((i, db, sb.host_blocks[i]))
        for b in sb.device_blocks:
            self._unref_block(b)
        sb.device_blocks = []
        sb.on_device = False
        return copies

    # ---------------------------------------------------------------- resume
    def can_resume(self, seq_id: int) -> bool:
        sb = self._seqs[seq_id]
        need = self.blocks_for_tokens(sb.num_tokens)
        return need <= self.free_device_blocks

    def resume(self, seq_id: int) -> List[Tuple[int, int]]:
        """Re-allocate device blocks for a host-resident sequence.
        Returns (host_block, device_block) swap-in copies to perform.
        Resume always takes *fresh, exclusively owned* blocks — it never
        re-maps shared prefix blocks, because the restored bytes come from
        this seq's private host checkpoints and the recomputed suffix is
        about to be rewritten in place."""
        sb = self._seqs[seq_id]
        if sb.on_device:
            raise ValueError(f"seq {seq_id} already resident")
        self._maybe_fault("alloc.resume", f"resume seq {seq_id}")
        kept_tokens = len(sb.host_blocks) * self.block_size
        kept_tokens = min(kept_tokens, sb.num_tokens)
        need = self.blocks_for_tokens(sb.num_tokens)
        if need > self.free_device_blocks:
            raise OutOfBlocks("cannot resume: device pool exhausted")
        sb.device_blocks = [self._alloc_block() for _ in range(need)]
        for b in sb.device_blocks:
            self._ref[b] += 1
        copies = [
            (hb, sb.device_blocks[i])
            for i, hb in enumerate(sb.host_blocks)
            if hb >= 0
        ]
        sb.host_blocks = [
            sb.host_blocks[i] if i < len(sb.host_blocks) else -1
            for i in range(need)
        ]
        sb.on_device = True
        return copies

    def tokens_resident(self, seq_id: int) -> int:
        """Tokens whose KV is on device (== num_tokens when resident)."""
        sb = self._seqs[seq_id]
        if sb.on_device:
            return sb.num_tokens
        return 0

    def tokens_recoverable_from_host(self, seq_id: int) -> int:
        sb = self._seqs[seq_id]
        n = 0
        for h in sb.host_blocks:
            if h >= 0:
                n += self.block_size
            else:
                break
        return min(n, sb.num_tokens)

    # ------------------------------------------------------------ speculation
    def snapshot(self) -> tuple:
        """Cheap copy of the full accounting state (free lists + per-seq
        block tables + sharing state) — O(sequences × blocks), plain ints.
        Taken before a *speculative* ``plan_iteration`` so the pipelined
        engine can roll back every allocation/preemption/resume/COW the
        plan made if the staged batch is invalidated before dispatch
        (DESIGN.md §13).  Device data is untouched by construction:
        planning only edits tables, never issues copies.  The hit/COW
        counters roll back too — speculative work must not inflate them."""
        return (
            list(self._free_device),
            list(self._free_host),
            {
                sid: (
                    sb.num_tokens,
                    list(sb.device_blocks),
                    list(sb.host_blocks),
                    sb.on_device,
                    sb.num_cached,
                    sb.prefix_keys,
                )
                for sid, sb in self._seqs.items()
            },
            list(self._ref),
            dict(self._index),
            list(self._cached_free),
            (self.prefix_hits, self.prefix_tokens_saved, self.cow_copies),
        )

    def restore(self, snap: tuple) -> None:
        """Inverse of ``snapshot``: rewind to exactly that accounting state
        (sequences registered/freed/preempted since are forgotten)."""
        free_d, free_h, seqs, ref, index, cached, counters = snap
        self._free_device = list(free_d)
        self._free_host = list(free_h)
        self._seqs = {
            sid: SeqBlocks(
                seq_id=sid,
                num_tokens=nt,
                device_blocks=list(db),
                host_blocks=list(hb),
                on_device=od,
                num_cached=nc,
                prefix_keys=list(pk),
            )
            for sid, (nt, db, hb, od, nc, pk) in seqs.items()
        }
        self._ref = list(ref)
        self._index = dict(index)
        self._key_of_block = {b: k for k, b in self._index.items()}
        self._cached_free = OrderedDict((b, None) for b in cached)
        self.prefix_hits, self.prefix_tokens_saved, self.cow_copies = counters

    def drop_host_block(self, seq_id: int, block_index: int) -> None:
        """Release one host checkpoint slot of a sequence (fault recovery:
        a scheduler rollback can resurrect host-table entries whose bytes
        the engine's ``HostKVStore`` already consumed — the runtime
        reconciles by dropping such entries so resume never counts tokens
        it cannot actually restore)."""
        sb = self._seqs[seq_id]
        h = sb.host_blocks[block_index]
        if h >= 0:
            self._free_host.append(h)
            sb.host_blocks[block_index] = -1

    # ------------------------------------------------------------------ free
    def free_seq(self, seq_id: int) -> None:
        sb = self._seqs.pop(seq_id)
        for b in sb.device_blocks:
            self._unref_block(b)
        for h in sb.host_blocks:
            if h >= 0:
                self._free_host.append(h)

    # ------------------------------------------------------------ invariants
    def check_invariants(self) -> None:
        """Raises AssertionError on any accounting violation (tests)."""
        refs: Counter = Counter()
        for sb in self._seqs.values():
            assert len(set(sb.device_blocks)) == len(sb.device_blocks), (
                f"seq {sb.seq_id}: device table has duplicate blocks"
            )
            for b in sb.device_blocks:
                refs[b] += 1
            if sb.on_device:
                assert len(sb.device_blocks) == self.blocks_for_tokens(
                    sb.num_tokens
                ), f"seq {sb.seq_id}: block count != token count"
            else:
                assert not sb.device_blocks
        free_set = set(self._free_device)
        cached_set = set(self._cached_free)
        assert len(free_set) == len(self._free_device), "free device list has dups"
        assert not (free_set & cached_set), "block both free and cached-free"
        assert not (free_set | cached_set) & set(refs), (
            "referenced block on a free list"
        )
        for b in range(self.num_device_blocks):
            assert self._ref[b] == refs.get(b, 0), (
                f"block {b}: refcount {self._ref[b]} != "
                f"{refs.get(b, 0)} live table references"
            )
        assert (
            len(free_set) + len(cached_set) + len(refs)
            == self.num_device_blocks
        ), "device blocks leaked or double-freed"
        # Content index: bijective, never aimed at a plain-free block.
        assert len(set(self._index.values())) == len(self._index), (
            "two chain keys index one block"
        )
        assert len(self._key_of_block) == len(self._index)
        for key, b in self._index.items():
            assert self._key_of_block.get(b) == key, "index/inverse mismatch"
            assert b not in free_set, f"index points at free block {b}"
        for b in cached_set:
            assert b in self._key_of_block, "cached-free block lost its key"

        hseen: Set[int] = set(self._free_host)
        assert len(hseen) == len(self._free_host), "free host list has dups"
        for sb in self._seqs.values():
            for h in sb.host_blocks:
                if h >= 0:
                    assert h not in hseen, f"host block {h} double-owned"
                    hseen.add(h)
        assert len(hseen) == self.num_host_blocks, "host blocks leaked"
