"""Fused ragged paged attention: the wrapper of the hand-written CUDA kernel
``csrc/ragged_paged_attention.cu``, which replaces the Pallas TPU kernel
``src/repro/kernels/paged_attention.py::ragged_paged_attention``.

The wrapper takes CUDA tensors only and launches the kernel or raises.  Its
plain version, ``ragged_paged_attention_ref`` (from ``kvcache.cache_ops``),
is what ``kernels.ops`` uses for CPU tensors and what the kernel is held
against on the card.
"""
from __future__ import annotations

import ctypes

import torch

from ..kvcache.cache_ops import ragged_paged_attention_ref  # noqa: F401
from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)


def _lib():
    fn = build.load("ragged_paged_attention").ragged_paged_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                       ctypes.c_float, ctypes.c_float, p]
        fn.restype = i
    return fn


def ragged_paged_attention(
    q: torch.Tensor,  # (S, Qmax, H, D)
    k_pool: torch.Tensor,  # (N, page, Hkv, D)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (S, M) int32, -1 padded
    q_positions: torch.Tensor,  # (S, Qmax) int32
    kv_lens: torch.Tensor,  # (S,) int32
    *,
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Launch the fused ragged paged-attention kernel. Returns (S, Qmax, H, D)
    in the dtype of ``q``.  ``ragged_paged_attention.launches`` counts the
    launches."""
    tensors = (q, k_pool, v_pool, block_tables, q_positions, kv_lens)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("ragged_paged_attention: all tensors must be on one CUDA device")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"ragged_paged_attention: q/k/v must share float32 or bfloat16, got "
                         f"{q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if any(t.dtype != torch.int32 for t in (block_tables, q_positions, kv_lens)):
        raise ValueError("ragged_paged_attention: tables, q_positions, kv_lens must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ragged_paged_attention: all tensors must be contiguous")
    s, qmax, h, d = q.shape
    n, page, hkv, dk = k_pool.shape
    if (
        v_pool.shape != k_pool.shape or dk != d or h % hkv
        or block_tables.ndim != 2 or block_tables.shape[0] != s
        or q_positions.shape != (s, qmax) or kv_lens.shape != (s,)
    ):
        raise ValueError(
            f"ragged_paged_attention: bad shapes q{tuple(q.shape)} pool{tuple(k_pool.shape)} "
            f"tables{tuple(block_tables.shape)} q_pos{tuple(q_positions.shape)} "
            f"kv_lens{tuple(kv_lens.shape)}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"ragged_paged_attention: head dim {d} not in {HEAD_DIMS}")
    if s > 65535 or hkv > 65535:
        raise ValueError("ragged_paged_attention: too many sequences or KV heads for the grid")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    rc = _lib()(
        _DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), q_positions.data_ptr(), kv_lens.data_ptr(),
        out.data_ptr(), s, qmax, h, hkv, d, page, block_tables.shape[1],
        float(d) ** -0.5, float(logit_softcap),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"ragged_paged_attention: CUDA error {rc} at launch")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
