"""PyTorch ops over the *paged* physical KV layout.

Physical pool per layer: ``k_pool, v_pool: (num_blocks, block_size, Hkv, D)``.
Sequences address it through ``block_tables: (S, max_blocks_per_seq) int32``
(-1 padded).

Scatters update the pool **in place** (the JAX reference returns new
arrays).  The plain attention and gather functions here are the oracles the
hand-written CUDA kernels are held against (``kernels/ops.py`` sends CPU
tensors to them).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _kept_slots(
    num_blocks: int,
    block_size: int,
    rows: torch.Tensor,  # (T,) block row per token, any value
    offsets: torch.Tensor,  # (T,) slot within the block
    keep: torch.Tensor,  # (T,) bool: False drops the write
):
    """Where ``_scatter_kept`` writes, with no read-back of ``keep`` to the
    host: ``(slots, first, any_kept)``, the flat pool slot of each token --
    a dropped token takes the first kept token's slot, or slot 0 when none
    is kept -- and the first kept index and whether it is kept, as
    one-element tensors (``index_select``, never ``x[t]`` with a 0-d tensor
    ``t``, which reads ``t`` back to the host).  K and V share them."""
    dst = rows.long().clamp(0, num_blocks - 1) * block_size + offsets.long()
    first = torch.argmax(keep.to(torch.int32)).reshape(1)  # 0 if none is kept
    any_kept = keep.index_select(0, first)  # (1,)
    fill_dst = torch.where(any_kept, dst.index_select(0, first), 0)
    return torch.where(keep, dst, fill_dst), first, any_kept


def _scatter_kept(
    pool: torch.Tensor,  # (num_blocks, bs, Hkv, D), contiguous
    slots,  # _kept_slots(...) of this pool's shape
    keep: torch.Tensor,  # (T,) bool: False drops the write
    new: torch.Tensor,  # (T, Hkv, D)
) -> None:
    """``pool[rows[i], offsets[i]] = new[i]`` for the kept ``i``, in place,
    with no read-back of ``keep`` to the host.

    A dropped write is turned into a copy of the first kept write (same
    slot, same value), so the duplicate is harmless in any order; when
    nothing is kept it rewrites slot 0 with its own value."""
    dst, first, any_kept = slots
    n, bs = pool.shape[:2]
    flat = pool.view(n * bs, *pool.shape[2:])
    fill_val = torch.where(any_kept[:, None, None], new.index_select(0, first), flat[:1])
    val = torch.where(keep[:, None, None], new, fill_val.to(new.dtype))
    flat.index_copy_(0, dst, val.to(pool.dtype))


def _scatter_kv(k_pool, v_pool, rows, offsets, keep, k_new, v_new) -> None:
    """``_scatter_kept`` of the new K and V into their pools, in place."""
    slots = _kept_slots(k_pool.shape[0], k_pool.shape[1], rows, offsets, keep)
    _scatter_kept(k_pool, slots, keep, k_new)
    _scatter_kept(v_pool, slots, keep, v_new)


def append_paged(
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    k_new: torch.Tensor,  # (B, Hkv, D) — one token per sequence
    v_new: torch.Tensor,
    block_tables: torch.Tensor,  # (B, M)
    seq_lens: torch.Tensor,  # (B,) length BEFORE the append
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter one new token per sequence into its tail block, in place.

    Negative (padding) table entries and positions past the table width
    drop the write instead of aliasing a real block, as in the reference."""
    bs, m = k_pool.shape[1], block_tables.shape[1]
    col = seq_lens.long() // bs
    rows = block_tables.gather(1, col.clamp(0, m - 1)[:, None])[:, 0]
    keep = (rows >= 0) & (rows < k_pool.shape[0]) & (col < m)
    _scatter_kv(k_pool, v_pool, rows, seq_lens % bs, keep, k_new, v_new)
    return k_pool, v_pool


def write_paged_chunk(
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    k_new: torch.Tensor,  # (B, L, Hkv, D) — chunked-prefill tokens
    v_new: torch.Tensor,
    block_tables: torch.Tensor,  # (B, M)
    positions: torch.Tensor,  # (B, L) absolute token positions of the chunk
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter a multi-token prefill chunk into each sequence's blocks, in
    place.  Positions landing on padding (negative table entries, or beyond
    the table width) drop the write rather than aliasing a real block."""
    bs, m = k_pool.shape[1], block_tables.shape[1]
    col = positions.long() // bs
    rows = block_tables.gather(1, col.clamp(0, m - 1))  # (B, L)
    keep = (rows >= 0) & (rows < k_pool.shape[0]) & (col < m)
    offs = (positions % bs).reshape(-1)
    rows, keep = rows.reshape(-1), keep.reshape(-1)
    _scatter_kv(k_pool, v_pool, rows, offs, keep, k_new.reshape(-1, *k_new.shape[2:]),
                v_new.reshape(-1, *v_new.shape[2:]))
    return k_pool, v_pool


def write_ragged(
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    k_new: torch.Tensor,  # (T, Hkv, D) — flattened ragged token batch
    v_new: torch.Tensor,
    dst_rows: torch.Tensor,  # (T,) physical pool row per token
    dst_offsets: torch.Tensor,  # (T,) slot within the block
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter a flattened ragged token batch into the pool, in place.

    Rows below 0 or at/after the pool's block count drop the write, as in
    the reference, through ``_scatter_kept``: nothing is read back to the
    host."""
    keep = (dst_rows >= 0) & (dst_rows < k_pool.shape[0])
    _scatter_kv(k_pool, v_pool, dst_rows, dst_offsets, keep, k_new, v_new)
    return k_pool, v_pool


def copy_blocks(
    pool: torch.Tensor,  # (..., num_blocks, bs, Hkv, D) — block axis `dim`
    src_ids: torch.Tensor,  # (N,) physical source blocks
    dst_ids: torch.Tensor,  # (N,) physical destination blocks
    dim: int = 0,
) -> torch.Tensor:
    """Pool-internal copy ``pool[dst] = pool[src]``, in place: the
    copy-on-write unit (DESIGN.md §14).  Every source is read before any
    destination is written, like the reference's functional update."""
    src = pool.index_select(dim, src_ids.long())
    pool.index_copy_(dim, dst_ids.long(), src)
    return pool


def gather_paged(
    pool: torch.Tensor,  # (num_blocks, bs, Hkv, D)
    block_tables: torch.Tensor,  # (B, M)
    max_ctx: int,
) -> torch.Tensor:
    """Gather per-sequence contiguous KV (B, max_ctx, Hkv, D); negative
    table entries read as zeros."""
    bs = pool.shape[1]
    m = max_ctx // bs
    tables = block_tables[:, :m].long()
    gathered = pool[tables.clamp(min=0)]  # (B, m, bs, Hkv, D)
    gathered = gathered.masked_fill((tables < 0)[:, :, None, None, None], 0)
    return gathered.reshape(tables.shape[0], m * bs, *pool.shape[2:])


def paged_attention_ref(
    q: torch.Tensor,  # (B, H, D) — single decode token per sequence
    k_pool: torch.Tensor,  # (num_blocks, bs, Hkv, D)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (B, M)
    seq_lens: torch.Tensor,  # (B,) tokens valid in the cache (incl. current)
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Plain version of the decode attention kernel.  Returns (B, H, D) in
    the dtype of ``q``.

    Keeps key ``t`` iff ``t < seq_len`` and its page's table entry is not
    negative; masked scores are -1e30 (after the softcap) and the softmax
    runs in fp32.  A row that keeps no key (``seq_len = 0``) comes out 0,
    as the Pallas kernel's safe divisor gives.  A negative entry below
    ``seq_len`` never occurs in the engine; the reference's kernel reads
    page 0 there and its jnp oracle zeros, so the port masks it."""
    b, h, d = q.shape
    bs = k_pool.shape[1]
    m = block_tables.shape[1]
    max_ctx = m * bs
    k = gather_paged(k_pool, block_tables, max_ctx).float()  # (B, T, Hkv, D)
    v = gather_paged(v_pool, block_tables, max_ctx).float()
    hkv = k.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d).float()
    scores = torch.einsum("bhgd,bthd->bhgt", qg, k) * (d**-0.5)
    if logit_softcap:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    pos = torch.arange(max_ctx, device=q.device)
    valid = (pos[None, :] < seq_lens[:, None]) & (
        block_tables.repeat_interleave(bs, dim=1) >= 0
    )  # (B, T)
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = F.softmax(scores, dim=-1) * valid.any(-1)[:, None, None, None]
    out = torch.einsum("bhgt,bthd->bhgd", probs, v)
    return out.reshape(b, h, d).to(q.dtype)


def ragged_paged_attention_ref(
    q: torch.Tensor,  # (S, Qmax, H, D) — per-sequence padded query tokens
    k_pool: torch.Tensor,  # (num_blocks, bs, Hkv, D)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (S, M)
    q_positions: torch.Tensor,  # (S, Qmax) absolute position of each query
    kv_lens: torch.Tensor,  # (S,) valid context incl. this iteration's tokens
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Plain version of the fused ragged paged-attention kernel.

    The mask keeps ``kv_pos <= q_pos`` and ``kv_pos < kv_len``; masked
    scores are -1e30; the softmax runs in fp32.  A row that keeps no key
    (a padded sequence with ``kv_len = 0``) comes out 0, as the kernels'
    safe divisor gives.  Returns (S, Qmax, H, D) in the dtype of ``q``."""
    s, tq, h, d = q.shape
    bs = k_pool.shape[1]
    max_ctx = block_tables.shape[1] * bs
    k = gather_paged(k_pool, block_tables, max_ctx).float()  # (S, T, Hkv, D)
    v = gather_paged(v_pool, block_tables, max_ctx).float()
    hkv = k.shape[2]
    qg = q.reshape(s, tq, hkv, h // hkv, d).float()
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k) * (d**-0.5)
    if logit_softcap:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    kv_pos = torch.arange(max_ctx, device=q.device)
    mask = (kv_pos[None, None, :] <= q_positions[:, :, None]) & (
        kv_pos[None, None, :] < kv_lens[:, None, None]
    )  # (S, Qmax, T)
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = F.softmax(scores, dim=-1)
    probs = probs * mask.any(-1)[:, None, None, :, None]
    out = torch.einsum("bhgts,bshd->bthgd", probs, v)
    return out.reshape(s, tq, h, d).to(q.dtype)


def checkpoint_gather_ref(
    pool: torch.Tensor,  # (P, num_blocks, bs, Hkv, D) period-stacked leaf
    block_ids: torch.Tensor,  # (K,) device blocks to checkpoint
) -> torch.Tensor:
    """Plain version of the checkpoint gather kernel: the selected blocks of
    every period packed into a dense (P, K, bs, Hkv, D) staging buffer."""
    return pool[:, block_ids.long()]
