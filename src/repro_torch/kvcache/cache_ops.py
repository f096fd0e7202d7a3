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
    the reference.  Finding the kept tokens reads the mask back to the host
    once (one synchronisation on a GPU); the engine's rows are always
    valid."""
    n = k_pool.shape[0]
    keep = torch.nonzero((dst_rows >= 0) & (dst_rows < n)).squeeze(1)
    rows, offs = dst_rows[keep].long(), dst_offsets[keep].long()
    k_pool[rows, offs] = k_new[keep]
    v_pool[rows, offs] = v_new[keep]
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
