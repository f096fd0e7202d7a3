"""Layers of the serving paths and of ``forward_full``, in PyTorch.

Counterparts of ``src/repro/models/layers.py``: rmsnorm, split-half RoPE,
the QKV / output projections, the MLP, the full-sequence attention, the
VLM's cross-attention over static image K/V, the contiguous KV cache and
its cached attention, the fused ragged paged attention, and the split
path's paged prefill and decode attention.
Layouts are the reference's, so tests compare like with like:
activations (B, T, d_model), projections ``wq (d, H, hd)``, ``wo (H, hd, d)``,
contiguous caches (B, C, Hkv, D), paged pools (num_blocks, block_size, Hkv, D).

Tensor-parallel serving (DESIGN.md §11): with a ``mesh`` (a
``launch.mesh.ServingMesh``) the paged layers take pools laid out over its
shards (``distributed.sharding.HeadSharded``).  q/k/v are projected once,
with the full weights, on the lead device and split by heads into
contiguous per-shard tensors; each shard scatters its heads of the new K/V
into its own pool and attends over them; the attention output is gathered
along heads before the output projection.  So every matmul reduces over the
same operands in the same order as without a mesh.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import over_kv_shards, split_heads
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
    """(B, Tq), (B, Tk) -> bool (B, 1, Tq, Tk): True = attend.  Its one
    caller is the split path's paged prefill, and the paged paths take no
    sliding-window arch (``transformer.supports_paged``), so the reference's
    ``sliding_window`` argument is left out; windowed attention runs through
    ``attend_cache`` and the flash attention."""
    return k_positions[:, None, None, :] <= q_positions[:, None, :, None]


def dense_attention(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # (B, T, d_model)
    positions: torch.Tensor,  # (B, T), 0..T-1 on every row
) -> torch.Tensor:
    """Full-sequence self-attention (``forward_full``), causal or, for an
    encoder (``cfg.causal`` False), bidirectional.  The attention runs
    through ``kernels.ops.flash_attention`` at every length: the flash
    kernel on CUDA, its plain version on the CPU.  (The reference switches
    to its blockwise jnp form above 1024 tokens and notes that the Pallas
    flash kernel replaces it on the TPU; the port keeps no second plain
    version.)  Queries and keys sit at positions 0..T-1, as ``forward_full``
    builds them; the reference's ``kv_src`` is ``cross_attention``'s."""
    q, k, v = project_qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    attn = kernel_ops.flash_attention(
        q, k, v, causal=cfg.causal, sliding_window=cfg.sliding_window,
        logit_softcap=cfg.logit_softcap,
    )
    return out_proj(p, attn)


def cross_attention(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # (B, T, d_model) text
    cross_k: torch.Tensor,  # (B, P, Hkv, D) from project_cross_kv
    cross_v: torch.Tensor,
) -> torch.Tensor:
    """VLM cross-attention: q from the text (no RoPE), the static image K/V,
    no mask.  Every call, prefill chunk or decode step, runs through
    ``kernels.ops.flash_attention`` with ``causal=False``: the flash kernel
    on CUDA, its plain version on the CPU."""
    q = _proj2d(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    attn = kernel_ops.flash_attention(q, cross_k, cross_v, causal=False,
                                      logit_softcap=cfg.logit_softcap)
    return out_proj(p, attn)


def project_cross_kv(
    cfg: ModelConfig, p: Params, img: torch.Tensor  # (B, P, d_model) projected image
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The static cross-attention K/V, computed once per request (at its
    prefill chunk at offset 0)."""
    k = _proj2d(img, p["wk"])
    v = _proj2d(img, p["wv"])
    if "bk" in p:
        k = k + p["bk"]
        v = v + p["bv"]
    return k, v


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
    an invalid (padded) token leaves its slot as it was.  Returns ``cache``.
    A row's positions are consecutive, so C of them fill C distinct slots:
    more than C tokens (a sequence longer than a ring) are written C at a
    time, in order, and the last writer of a slot wins, as token-by-token
    writes would leave it."""
    b, l = positions.shape
    c = cache["k"].shape[1]
    if l > c:
        for j in range(0, l, c):
            write_kv(cache, k_new[:, j:j + c], v_new[:, j:j + c], positions[:, j:j + c],
                     None if valid is None else valid[:, j:j + c])
        return cache
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

    A prefill chunk whose rows' offsets are known on the host
    (``q_offsets``, as ``prefill_chunk`` passes them) runs the flash
    attention (kernel on CUDA, plain version on the CPU), one call when the
    rows share their offset, one per row otherwise; it reads no value back
    to the host.  On a full cache the chunk is written first and the call
    reads the cache's first ``off + L`` slots with ``q_offset = off``:
    ``attend_cache`` exactly, when slots ``0 .. off + L - 1`` hold positions
    ``0 .. off + L - 1``, as a cache filled chunk by chunk from position 0
    does.  With a sliding window W the call reads, before the chunk is
    written, the positions ``max(0, off - W + 1) .. off - 1`` the cache
    holds (slot ``p % C`` of a ring), in position order, followed by the
    chunk's own K/V, with ``q_offset`` the number of those earlier
    positions and the window; then the chunk is written.  So every query
    sees every key of its window, as in ``forward_full``.  (The reference
    writes the whole chunk into its ring first, so a chunk that crosses the
    window overwrites keys its own first queries still need; ROADMAP
    Queue 3.)  A padded token of a row (``valid`` False) is not written,
    and only the row's real tokens' outputs are read.  Decode steps (no
    host offsets) keep the plain masked ``attend_cache`` over the cache
    after the write: exact for a ring too, and the reference has no kernel
    there either."""
    q, k, v = project_qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    length = x.shape[1]
    window = cfg.sliding_window
    if q_offsets is None:
        write_kv(cache, k, v, positions, valid)
        return out_proj(p, attend_cache(cfg, q, cache, positions)), cache
    if window:
        kc = k.to(cache["k"].dtype)
        vc = v.to(cache["v"].dtype)
        cap = cache["k"].shape[1]

    def flash(rows, off):
        if not window:
            return kernel_ops.flash_attention(
                q[rows], cache["k"][rows, :off + length], cache["v"][rows, :off + length],
                causal=True, q_offset=off, logit_softcap=cfg.logit_softcap,
            )
        lo = max(0, off - window + 1)
        slots = torch.arange(lo, off, device=q.device) % cap
        kk = torch.cat([cache["k"][rows].index_select(1, slots), kc[rows]], dim=1)
        vv = torch.cat([cache["v"][rows].index_select(1, slots), vc[rows]], dim=1)
        return kernel_ops.flash_attention(
            q[rows], kk, vv, causal=True, sliding_window=window, q_offset=off - lo,
            logit_softcap=cfg.logit_softcap,
        )

    if not window:
        write_kv(cache, k, v, positions, valid)
    offs = [int(o) for o in q_offsets]
    if len(set(offs)) == 1:
        attn = flash(slice(None), offs[0])
    else:
        attn = torch.cat([flash(slice(i, i + 1), o) for i, o in enumerate(offs)])
    if window:
        write_kv(cache, k, v, positions, valid)
    return out_proj(p, attn), cache


def _write_shards(write, pool, mesh, k_new, v_new, *addressing) -> None:
    """``write`` (a ``cache_ops`` scatter) of the new K/V into each shard's
    part of the layer's pools, in place: its heads of ``k_new``/``v_new``
    (all of them where the pools replicate, once per device), and its own
    copies of the addressing tensors."""
    kp, vp = pool["k"], pool["v"]
    ks, vs = split_heads(k_new, mesh), split_heads(v_new, mesh)
    for s in kp.writers():
        dev = kp.parts[s].device
        write(kp.parts[s], vp.parts[s], ks[s], vs[s], *(t.to(dev) for t in addressing))


def _prefill_attend(cfg, q, k_pool, v_pool, block_tables, positions):
    """Causal attention of a prefill chunk over the gathered per-sequence
    context, in plain PyTorch (the reference has no kernel here)."""
    max_ctx = block_tables.shape[1] * k_pool.shape[1]
    kk = gather_paged(k_pool, block_tables, max_ctx)  # (B, T, Hkv, D)
    vv = gather_paged(v_pool, block_tables, max_ctx)
    kv_pos = torch.arange(max_ctx, device=q.device).expand(q.shape[0], max_ctx)
    # causal masking doubles as the validity mask: slots at kv_pos <= q_pos
    # were all written by this sequence
    return gqa_scores_softmax_values(q, kk, vv, causal_mask(positions, kv_pos),
                                     cfg.logit_softcap)


def paged_prefill_attention(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # (B, L, d_model) — prefill chunk
    pool: Dict[str, torch.Tensor],  # this layer's {"k", "v"}, updated in place
    block_tables: torch.Tensor,  # (B, M)
    positions: torch.Tensor,  # (B, L) absolute positions of the chunk
    mesh=None,  # tensor-parallel serving mesh: pool leaves are HeadSharded
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Chunked prefill against the shared paged pool: scatter the chunk's
    roped KV into the pool, then attend causally over the gathered
    per-sequence context.  The reference runs this in plain jnp (no
    kernel), so plain PyTorch is its port; on a mesh it runs per shard."""
    q, k, v = project_qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if mesh is None:
        write_paged_chunk(pool["k"], pool["v"], k, v, block_tables, positions)
        attn = _prefill_attend(cfg, q, pool["k"], pool["v"], block_tables, positions)
    else:
        _write_shards(write_paged_chunk, pool, mesh, k, v, block_tables, positions)
        attn, _ = over_kv_shards(
            lambda *a: _prefill_attend(cfg, *a), q, pool["k"], pool["v"],
            (block_tables, positions), mesh, 2,
        )
    return out_proj(p, attn), pool


def paged_decode_attention(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # (B, 1, d_model)
    pool: Dict[str, torch.Tensor],  # this layer's {"k", "v"}, updated in place
    block_tables: torch.Tensor,  # (B, M)
    positions: torch.Tensor,  # (B, 1) — the new token's absolute position
    mesh=None,  # tensor-parallel serving mesh: pool leaves are HeadSharded
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode against the shared paged pool: append the token's
    KV, then the paged decode attention kernel (CUDA) or its plain version
    (CPU), per shard on a mesh."""
    q, k, v = project_qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if mesh is None:
        append_paged(pool["k"], pool["v"], k[:, 0], v[:, 0], block_tables, positions[:, 0])
        out = kernel_ops.paged_attention(
            q[:, 0], pool["k"], pool["v"], block_tables, positions[:, 0] + 1,
            logit_softcap=cfg.logit_softcap,
        )
    else:
        _write_shards(append_paged, pool, mesh, k[:, 0], v[:, 0], block_tables,
                      positions[:, 0])
        out = kernel_ops.paged_attention_sharded(
            q[:, 0], pool["k"], pool["v"], block_tables, positions[:, 0] + 1, mesh,
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
    mesh=None,  # tensor-parallel serving mesh: pool leaves are HeadSharded
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Fused mixed-batch attention against the shared paged pool.

    Projects and ropes the whole flat batch, scatters every new token's KV
    into the pool in place (one ``write_ragged``, per shard on a mesh), runs
    the ragged paged attention kernel (CUDA) or its plain version (CPU)
    once (once per shard on a mesh), and gathers the output back to the
    flat token axis.  Returns (out, pool)."""
    q, k, v = project_qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q_pad = q[0][meta.qpad.long()]  # (S, Qmax, H, D)
    if mesh is None:
        write_ragged(pool["k"], pool["v"], k[0], v[0], meta.dst_row, meta.dst_off)
        out = kernel_ops.ragged_paged_attention(
            q_pad, pool["k"], pool["v"], block_tables, meta.q_pos, meta.kv_lens,
            logit_softcap=cfg.logit_softcap,
        )
    else:
        _write_shards(write_ragged, pool, mesh, k[0], v[0], meta.dst_row, meta.dst_off)
        out = kernel_ops.ragged_paged_attention_sharded(
            q_pad, pool["k"], pool["v"], block_tables, meta.q_pos, meta.kv_lens, mesh,
            logit_softcap=cfg.logit_softcap,
        )
    flat = out[meta.unpad_seq.long(), meta.unpad_j.long()][None]  # (1, T, H, D)
    return out_proj(p, flat), pool
