"""KV-checkpoint page gather: the wrapper of the hand-written CUDA kernel
``csrc/checkpoint_gather.cu``, which replaces the Pallas TPU kernel
``src/repro/kernels/kv_checkpoint.py::checkpoint_gather``.

The wrapper takes CUDA tensors only and launches the kernel or raises.  Its
plain version, ``checkpoint_gather_ref`` (from ``kvcache.cache_ops``), is
what ``kernels.ops`` uses for CPU tensors and what the kernel is held
against on the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..kvcache.cache_ops import checkpoint_gather_ref  # noqa: F401
from . import build

_DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    fn = build.load("checkpoint_gather").checkpoint_gather
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, ctypes.c_longlong, p]
        fn.restype = i
    return fn


def checkpoint_gather(
    pool: torch.Tensor,  # (P, N, page, Hkv, D) period-stacked pool leaf
    block_ids: torch.Tensor,  # (K,) int32, repeats allowed
    *,
    out: Optional[torch.Tensor] = None,  # (P, K, page, Hkv, D) staging slot
) -> torch.Tensor:
    """Launch the page gather: ``out[p, i] = pool[p, block_ids[i]]``.

    ``out`` lets the caller pack several leaves into one staging buffer; by
    default it is allocated.  ``checkpoint_gather.launches`` counts the
    launches."""
    if pool.device.type != "cuda" or block_ids.device != pool.device:
        raise ValueError("checkpoint_gather: pool and ids must be on one CUDA device")
    if pool.dtype not in _DTYPES:
        raise ValueError(f"checkpoint_gather: dtype {pool.dtype} is not float32 or bfloat16")
    if block_ids.dtype != torch.int32 or block_ids.ndim != 1:
        raise ValueError("checkpoint_gather: block_ids must be a 1-D int32 tensor")
    if pool.ndim != 5 or not pool.is_contiguous() or not block_ids.is_contiguous():
        raise ValueError("checkpoint_gather: pool must be a contiguous (P, N, page, Hkv, D) leaf")
    periods, n = pool.shape[:2]
    k = block_ids.shape[0]
    shape = (periods, k, *pool.shape[2:])
    if out is None:
        out = torch.empty(shape, dtype=pool.dtype, device=pool.device)
    elif (out.shape != shape or out.dtype != pool.dtype or out.device != pool.device
          or not out.is_contiguous()):
        raise ValueError(f"checkpoint_gather: out must be a contiguous {shape} {pool.dtype}")
    page_bytes = pool[0, 0].numel() * pool.element_size()
    if page_bytes % 16 or pool.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("checkpoint_gather: pages and buffers must be 16-byte aligned")
    if k == 0:
        return out
    if k > 65535 or periods > 65535:
        raise ValueError("checkpoint_gather: too many ids or periods for the grid")
    rc = _lib()(
        pool.data_ptr(), block_ids.data_ptr(), out.data_ptr(), periods, n, k,
        page_bytes, torch.cuda.current_stream(pool.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"checkpoint_gather: CUDA error {rc} at launch")
    checkpoint_gather.launches += 1
    return out


checkpoint_gather.launches = 0
