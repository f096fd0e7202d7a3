"""Layers of the serving paths and of ``forward_full``, in PyTorch.

Counterparts of ``src/repro/models/layers.py``: rmsnorm, split-half RoPE,
the QKV / output projections, the MLP, the full-sequence attention, the
contiguous KV cache and its cached attention, the fused ragged paged
attention, and the split path's paged prefill and decode attention.
Layouts are the reference's, so tests compare like with like:
activations (B, T, d_model), projections ``wq (d, H, hd)``, ``wo (H, hd, d)``,
contiguous caches (B, C, Hkv, D), paged pools (num_blocks, block_size, Hkv, D).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops as kernel_ops
from ..kvcache.cache_ops import (
    NEG_INF,
    append_paged,
    gather_paged,
    write_paged_chunk,
    write_ragged,
)
from .config import ModelConfig

Params = Dict[str, torch.Tensor]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalise in fp32, cast back to the input dtype, then scale by ``w``."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    )


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, T, H, D); positions: (B, T) absolute token positions.
    Split-half RoPE (the first and second halves of D rotate as pairs)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., None].float() * freqs  # (B, T, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _proj2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, T, d) @ (d, H, hd) as one 2-D matmul + reshape."""
    d, h, hd = w.shape
    b, t, _ = x.shape
    return (x @ w.reshape(d, h * hd)).reshape(b, t, h, hd)


def project_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor):
    q = _proj2d(x, p["wq"])
    k = _proj2d(x, p["wk"])
    v = _proj2d(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def out_proj(p: Params, attn: torch.Tensor) -> torch.Tensor:
    h, hd, d = p["wo"].shape
    b, t = attn.shape[:2]
    out = attn.reshape(b, t, h * hd) @ p["wo"].reshape(h * hd, d)
    if "bo" in p:
        out = out + p["bo"]
    return out


def mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    up = x @ p["w_up"]
    if "b_up" in p:
        up = up + p["b_up"]
    if cfg.activation == "swiglu":
        up = F.silu(x @ p["w_gate"]) * up
    elif cfg.activation == "geglu":
        up = F.gelu(x @ p["w_gate"], approximate="tanh") * up
    else:
        up = F.gelu(up, approximate="tanh")
    down = up @ p["w_down"]
    if "b_down" in p:
        down = down + p["b_down"]
    return down


def gqa_scores_softmax_values(
    q: torch.Tensor,  # (B, Tq, H, D)
    k: torch.Tensor,  # (B, Tk, Hkv, D)
    v: torch.Tensor,
    mask: Optional[torch.Tensor],  # broadcastable to (B, 1, Tq, Tk)
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Grouped-query attention with an fp32 softmax; masked scores are
    -1e30.  Returns (B, Tq, H, D) in the dtype of ``q``."""
    b, tq, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, tq, hkv, h // hkv, d).float()
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) * (d**-0.5)
    if logit_softcap:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    if mask is not None:
        keep = mask[:, :, None, :, :] if mask.ndim == 4 else mask
        scores = scores.masked_fill(~keep, NEG_INF)
    probs = F.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", probs, v.float())
    return out.reshape(b, tq, h, d).to(q.dtype)


def causal_mask(q_positions: torch.Tensor, k_positions: torch.Tensor) -> torch.Tensor:
    """(B, Tq), (B, Tk) -> bool (B, 1, Tq, Tk): True = attend.  The paged
    paths never run sliding-window archs, so the window is left out."""
    return k_positions[:, None, None, :] <= q_positions[:, None, :, None]


def dense_attention(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # (B, T, d_model)
    positions: torch.Tensor,  # (B, T), 0..T-1 on every row
) -> torch.Tensor:
    """Full-sequence self-attention (``forward_full``).  The attention runs
    through ``kernels.ops.flash_attention`` at every length: the flash
    kernel on CUDA, its plain version on the CPU.  (The reference switches
    to its blockwise jnp form above 1024 tokens and notes that the Pallas
    flash kernel replaces it on the TPU; the port keeps no second plain
    version.)  Queries and keys sit at positions 0..T-1, as ``forward_full``
    builds them; cross-attention (``kv_src``) belongs to ROADMAP Queue 1,
    the contiguous fallback's other archs."""
    q, k, v = project_qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    attn = kernel_ops.flash_attention(
        q, k, v, causal=cfg.causal, sliding_window=cfg.sliding_window,
        logit_softcap=cfg.logit_softcap,
    )
    return out_proj(p, attn)


# ---------------------------------------------------------------------------
# Cached attention (contiguous layout, slot-position tracked)
#
# A KV cache is the dict {"k", "v", "pos"}:
#   k, v: (B, C, Hkv, D)
#   pos:  (B, C) int32 -- the absolute token position stored in each slot,
#         -1 for empty.  A full cache maps position p -> slot p; a
#         sliding-window cache is a ring with slot p % C.
# The port writes caches in place (the reference returns new arrays).
# ---------------------------------------------------------------------------


class KVCache:
    """Namespace for cache helpers (caches stay plain dicts)."""

    @staticmethod
    def init(batch, capacity, kv_heads, head_dim, dtype, device="cpu"
             ) -> Dict[str, torch.Tensor]:
        return {
            "k": torch.zeros((batch, capacity, kv_heads, head_dim), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, capacity, kv_heads, head_dim), dtype=dtype,
                             device=device),
            "pos": torch.full((batch, capacity), -1, dtype=torch.int32, device=device),
        }


def write_kv(
    cache: Dict[str, torch.Tensor],
    k_new: torch.Tensor,  # (B, L, Hkv, D)
    v_new: torch.Tensor,
    positions: torch.Tensor,  # (B, L) absolute positions
    valid: Optional[torch.Tensor] = None,  # (B, L) bool: False is not written
) -> Dict[str, torch.Tensor]:
    """Write L new tokens per sequence into slot ``position % C``, in place;
    an invalid (padded) token leaves its slot as it was.  Returns ``cache``."""
    b = positions.shape[0]
    c = cache["k"].shape[1]
    slots = positions.long() % c
    rows = torch.arange(b, device=positions.device)[:, None]
    positions = positions.to(torch.int32)
    if valid is not None:  # merge with the slots' old contents
        vm = valid[..., None, None]
        k_new = torch.where(vm, k_new.to(cache["k"].dtype), cache["k"][rows, slots])
        v_new = torch.where(vm, v_new.to(cache["v"].dtype), cache["v"][rows, slots])
        positions = torch.where(valid, positions, cache["pos"][rows, slots])
    cache["k"][rows, slots] = k_new.to(cache["k"].dtype)
    cache["v"][rows, slots] = v_new.to(cache["v"].dtype)
    cache["pos"][rows, slots] = positions
    return cache


def attend_cache(
    cfg: ModelConfig,
    q: torch.Tensor,  # (B, Tq, H, D), roped
    cache: Dict[str, torch.Tensor],
    q_positions: torch.Tensor,  # (B, Tq)
) -> torch.Tensor:
    """Causal (+ sliding-window) attention of q against every cache slot,
    masked by the slots' positions: the plain form, with no kernel."""
    kp = cache["pos"][:, None, None, :]  # (B, 1, 1, C)
    qp = q_positions[:, None, :, None]  # (B, 1, Tq, 1)
    valid = (kp >= 0) & (kp <= qp)
    if cfg.sliding_window:
        valid = valid & (kp > qp - cfg.sliding_window)
    return gqa_scores_softmax_values(q, cache["k"], cache["v"], valid,
                                     cfg.logit_softcap)


def cached_attention(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # (B, L, d_model): L = 1 decode, L > 1 prefill chunk
    cache: Dict[str, torch.Tensor],  # updated in place
    positions: torch.Tensor,  # (B, L) absolute positions of the new tokens
    valid: Optional[torch.Tensor] = None,  # (B, L) padding mask
    q_offsets: Optional[Sequence[int]] = None,  # host copy of positions[:, 0]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode step or prefill chunk against a contiguous cache.

    A prefill chunk on a full cache, with its rows' offsets known on the
    host (``q_offsets``, as ``prefill_chunk`` passes them), runs the flash
    attention (kernel on CUDA, plain version on the CPU) over the cache's
    first ``off + L`` slots with ``q_offset = off``: one call when the rows
    share their offset, one per row otherwise.  That is ``attend_cache``
    exactly when slots ``0 .. off + L - 1`` hold positions
    ``0 .. off + L - 1``, which a full cache filled chunk by chunk from
    position 0 does; and it reads no value back to the host.  A padded
    token of a row (``valid`` False) is not written, and only the row's
    real tokens' outputs are read.  Decode steps (no host offsets) and ring
    caches keep the plain masked ``attend_cache``: the reference has no
    kernel there either."""
    q, k, v = project_qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    write_kv(cache, k, v, positions, valid)
    length = x.shape[1]
    if q_offsets is None or cfg.sliding_window:
        return out_proj(p, attend_cache(cfg, q, cache, positions)), cache

    def flash(qq, kk, vv, off):
        return kernel_ops.flash_attention(
            qq, kk[:, :off + length], vv[:, :off + length], causal=True,
            q_offset=off, logit_softcap=cfg.logit_softcap,
        )

    offs = [int(o) for o in q_offsets]
    if len(set(offs)) == 1:
        attn = flash(q, cache["k"], cache["v"], offs[0])
    else:
        attn = torch.cat([flash(q[i:i + 1], cache["k"][i:i + 1], cache["v"][i:i + 1], o)
                          for i, o in enumerate(offs)])
    return out_proj(p, attn), cache


def paged_prefill_attention(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # (B, L, d_model) — prefill chunk
    pool: Dict[str, torch.Tensor],  # this layer's {"k", "v"}, updated in place
    block_tables: torch.Tensor,  # (B, M)
    positions: torch.Tensor,  # (B, L) absolute positions of the chunk
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Chunked prefill against the shared paged pool: scatter the chunk's
    roped KV into the pool, then attend causally over the gathered
    per-sequence context.  The reference runs this in plain jnp (no
    kernel), so plain PyTorch is its port."""
    q, k, v = project_qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    write_paged_chunk(pool["k"], pool["v"], k, v, block_tables, positions)
    max_ctx = block_tables.shape[1] * pool["k"].shape[1]
    kk = gather_paged(pool["k"], block_tables, max_ctx)  # (B, T, Hkv, D)
    vv = gather_paged(pool["v"], block_tables, max_ctx)
    kv_pos = torch.arange(max_ctx, device=x.device).expand(x.shape[0], max_ctx)
    # causal masking doubles as the validity mask: slots at kv_pos <= q_pos
    # were all written by this sequence
    attn = gqa_scores_softmax_values(q, kk, vv, causal_mask(positions, kv_pos),
                                     cfg.logit_softcap)
    return out_proj(p, attn), pool


def paged_decode_attention(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # (B, 1, d_model)
    pool: Dict[str, torch.Tensor],  # this layer's {"k", "v"}, updated in place
    block_tables: torch.Tensor,  # (B, M)
    positions: torch.Tensor,  # (B, 1) — the new token's absolute position
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode against the shared paged pool: append the token's
    KV, then the paged decode attention kernel (CUDA) or its plain version
    (CPU)."""
    q, k, v = project_qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    append_paged(pool["k"], pool["v"], k[:, 0], v[:, 0], block_tables, positions[:, 0])
    out = kernel_ops.paged_attention(
        q[:, 0], pool["k"], pool["v"], block_tables, positions[:, 0] + 1,
        logit_softcap=cfg.logit_softcap,
    )
    return out_proj(p, out[:, None]), pool


class RaggedMeta(NamedTuple):
    """Addressing metadata for one fused ragged token batch (DESIGN.md §12),
    built on the host by the engine:

      dst_row/dst_off  (T,)       KV-pool scatter target per new token
      qpad             (S, Qmax)  flat token index per padded query slot
      q_pos            (S, Qmax)  absolute position per padded query slot
      kv_lens          (S,)       valid context incl. this iteration
      unpad_seq/unpad_j (T,)      (sequence, slot) of each flat token
    """

    dst_row: torch.Tensor
    dst_off: torch.Tensor
    qpad: torch.Tensor
    q_pos: torch.Tensor
    kv_lens: torch.Tensor
    unpad_seq: torch.Tensor
    unpad_j: torch.Tensor


def paged_ragged_attention(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # (1, T, d_model) — flattened ragged token batch
    pool: Dict[str, torch.Tensor],  # this layer's {"k", "v"} (N, page, Hkv, D)
    block_tables: torch.Tensor,  # (S, M) int32
    positions: torch.Tensor,  # (1, T) absolute position of each flat token
    meta: RaggedMeta,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Fused mixed-batch attention against the shared paged pool.

    Projects and ropes the whole flat batch, scatters every new token's KV
    into the pool in place (one ``write_ragged``), runs the ragged paged
    attention kernel (CUDA) or its plain version (CPU) once, and gathers
    the output back to the flat token axis.  Returns (out, pool)."""
    q, k, v = project_qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    write_ragged(pool["k"], pool["v"], k[0], v[0], meta.dst_row, meta.dst_off)
    q_pad = q[0][meta.qpad.long()]  # (S, Qmax, H, D)
    out = kernel_ops.ragged_paged_attention(
        q_pad, pool["k"], pool["v"], block_tables, meta.q_pos, meta.kv_lens,
        logit_softcap=cfg.logit_softcap,
    )
    flat = out[meta.unpad_seq.long(), meta.unpad_j.long()][None]  # (1, T, H, D)
    return out_proj(p, flat), pool
