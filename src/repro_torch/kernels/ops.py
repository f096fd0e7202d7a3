"""Entry points of the kernel layer, dispatched by the tensor's device.

CUDA tensors go to the hand-written Hopper kernels; CPU tensors go to their
plain PyTorch versions.  There is no other switch: a CUDA call launches its
kernel or raises, and never falls back to the plain version.
"""
from __future__ import annotations

import torch

from ..kvcache.cache_ops import (
    checkpoint_gather_ref,
    paged_attention_ref,
    ragged_paged_attention_ref,
)
from . import flash_attention as _flash
from . import kv_checkpoint
from . import paged_attention as _attention
from .ref import flash_attention_ref

__all__ = ["ragged_paged_attention", "paged_attention", "checkpoint_gather",
           "flash_attention", "ragged_paged_attention_sharded",
           "paged_attention_sharded", "reset_launch_counts", "launch_counts"]

KERNELS = {
    "ragged_paged_attention": _attention.ragged_paged_attention,
    "paged_attention": _attention.paged_attention,
    "checkpoint_gather": kv_checkpoint.checkpoint_gather,
    "flash_attention": _flash.flash_attention,
    "ragged_paged_attention_sharded": _attention.ragged_paged_attention_sharded,
    "paged_attention_sharded": _attention.paged_attention_sharded,
}
# the sharded wrappers' counts besides ``launches``
SHARD_COUNTS = ("shard_launches", "fallbacks")


def _device_type(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return t.device.type


def ragged_paged_attention(q, k_pool, v_pool, block_tables, q_positions,
                           kv_lens, *, logit_softcap=0.0):
    """Fused mixed-batch attention over the paged pool (DESIGN.md §12)."""
    if _device_type(q) == "cuda":
        return _attention.ragged_paged_attention(
            q, k_pool, v_pool, block_tables, q_positions, kv_lens,
            logit_softcap=logit_softcap,
        )
    return ragged_paged_attention_ref(
        q, k_pool, v_pool, block_tables, q_positions, kv_lens,
        logit_softcap=logit_softcap,
    )


def paged_attention(q, k_pool, v_pool, block_tables, seq_lens, *,
                    logit_softcap=0.0):
    """Decode attention, one query token per sequence, over the paged pool
    (the split serving path)."""
    if _device_type(q) == "cuda":
        return _attention.paged_attention(
            q, k_pool, v_pool, block_tables, seq_lens,
            logit_softcap=logit_softcap,
        )
    return paged_attention_ref(
        q, k_pool, v_pool, block_tables, seq_lens, logit_softcap=logit_softcap,
    )


def ragged_paged_attention_sharded(q, k_pool, v_pool, block_tables, q_positions,
                                   kv_lens, mesh, *, logit_softcap=0.0):
    """``ragged_paged_attention`` over a tensor-parallel mesh's KV-head
    shards (DESIGN.md §11): q on the lead device, the pools ``HeadSharded``."""
    fn = (_attention.ragged_paged_attention_sharded if _device_type(q) == "cuda"
          else _attention.ragged_paged_attention_sharded_ref)
    return fn(q, k_pool, v_pool, block_tables, q_positions, kv_lens, mesh,
              logit_softcap=logit_softcap)


def paged_attention_sharded(q, k_pool, v_pool, block_tables, seq_lens, mesh, *,
                            logit_softcap=0.0):
    """``paged_attention`` over a tensor-parallel mesh's KV-head shards."""
    fn = (_attention.paged_attention_sharded if _device_type(q) == "cuda"
          else _attention.paged_attention_sharded_ref)
    return fn(q, k_pool, v_pool, block_tables, seq_lens, mesh, logit_softcap=logit_softcap)


def checkpoint_gather(pool, block_ids, *, out=None):
    """Pack the pages ``block_ids`` of a (P, N, page, Hkv, D) pool leaf into
    a dense (P, K, page, Hkv, D) staging buffer."""
    if _device_type(pool) == "cuda":
        return kv_checkpoint.checkpoint_gather(pool, block_ids, out=out)
    staged = checkpoint_gather_ref(pool, block_ids)
    if out is None:
        return staged
    return out.copy_(staged)


def flash_attention(q, k, v, *, causal=True, sliding_window=0, q_offset=0,
                    logit_softcap=0.0):
    """Attention of q (B, Tq, H, D) at positions ``q_offset + t`` over
    contiguous k/v (B, Tk, Hkv, D): the full-sequence attention of
    ``forward_full`` and the contiguous path's prefill chunks."""
    fn = _flash.flash_attention if _device_type(q) == "cuda" else flash_attention_ref
    return fn(q, k, v, causal=causal, sliding_window=sliding_window,
              q_offset=q_offset, logit_softcap=logit_softcap)


def launch_counts() -> dict:
    """Every kernel's launches, and the sharded wrappers' per-shard launches
    and fallbacks as ``"<name> shard_launches"`` and ``"<name> fallbacks"``."""
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    for name, fn in KERNELS.items():
        for c in SHARD_COUNTS:
            if hasattr(fn, c):
                counts[f"{name} {c}"] = getattr(fn, c)
    return counts


def reset_launch_counts() -> None:
    """Zeroes every kernel's launch count (and the paged kernels' counts of
    split-KV merges, and the sharded wrappers' other counts)."""
    for fn in KERNELS.values():
        fn.launches = 0
        for c in SHARD_COUNTS:
            if hasattr(fn, c):
                setattr(fn, c, 0)
    _attention.paged_attention.merge_launches = 0
    _attention.ragged_paged_attention.merge_launches = 0
