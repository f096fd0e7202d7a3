"""Paged attention: the wrappers of two hand-written CUDA kernels, each
replacing a Pallas TPU kernel of ``src/repro/kernels/paged_attention.py``:

* ``ragged_paged_attention`` (``csrc/ragged_paged_attention.cu``): the fused
  mixed batch of prefill chunks and decodes;
* ``paged_attention`` (``csrc/paged_attention.cu``): decode, one query token
  per sequence (the split serving path); bf16 on the tensor cores, with
  the keys split across blocks where few (sequence, KV head) pairs would
  leave the card idle (``decode_splits``).

The wrappers take CUDA tensors only and launch their kernel or raise.  Their
plain versions, ``ragged_paged_attention_ref`` and ``paged_attention_ref``
(from ``kvcache.cache_ops``), are what ``kernels.ops`` uses for CPU tensors
and what the kernels are held against on the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..kvcache.cache_ops import (  # noqa: F401
    paged_attention_ref,
    ragged_paged_attention_ref,
)
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
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("ragged_paged_attention: q and the pools must be 16-byte aligned")
    if s > 65535 or hkv > 65535:
        raise ValueError("ragged_paged_attention: too many sequences or KV heads for the grid")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    # CUDA launches on the calling thread's current device: make it q's
    with torch.cuda.device(q.device):
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


# fp32 (decode_kernel) keeps G * D fp32 accumulators in registers across
# its 128 threads (8 each), and a ring of 4 pages in shared memory; a larger
# G * D or page is refused.
MAX_GROUP_WIDTH = 1024
MAX_PAGE = 32
# bf16 (paged_tc_kernel) holds the G query heads of a KV head in its 4
# warps of 16 rows and the table row in shared memory, and takes any page
# size; a larger G or table is refused.
MAX_TC_GROUP = 64
MAX_TC_TABLE_WIDTH = 32768
# Split-KV of the bf16 kernel: splits are whole rounds of 64 keys, at least
# MIN_SPLIT_KEYS each (a shorter split saves less than its set-up and merge
# cost), enough of them for SPLIT_BLOCKS_PER_SM blocks per SM.
SPLIT_ROUND = 64
MIN_SPLIT_KEYS = 256
MAX_SPLITS = 32
SPLIT_BLOCKS_PER_SM = 2


def decode_splits(batch: int, kv_heads: int, max_keys: int, sms: int) -> Tuple[int, int]:
    """(number of splits, keys per split) of a bf16 decode call over a
    table of ``max_keys`` = M * page keys, from shapes alone (the split path
    reads nothing back): one split where the (sequence, KV head) pairs fill
    ``SPLIT_BLOCKS_PER_SM`` blocks per SM, else as many as fill them, at
    most ``MAX_SPLITS`` and no shorter than ``MIN_SPLIT_KEYS``.  Split i
    covers keys [i * keys, (i + 1) * keys); together they cover
    [0, max_keys) once."""
    rounds = max(1, -(-max_keys // SPLIT_ROUND))
    want = -(-SPLIT_BLOCKS_PER_SM * sms // max(1, batch * kv_heads))
    n = max(1, min(want, max_keys // MIN_SPLIT_KEYS, MAX_SPLITS))
    keys = SPLIT_ROUND * -(-rounds // n)
    return max(1, -(-max_keys // keys)), keys


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _decode_lib():
    fn = build.load("paged_attention").paged_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                       ctypes.c_float, ctypes.c_float, p]
        fn.restype = i
    return fn


def paged_attention(
    q: torch.Tensor,  # (B, H, D)
    k_pool: torch.Tensor,  # (N, page, Hkv, D)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (B, M) int32, -1 padded
    seq_lens: torch.Tensor,  # (B,) int32, valid tokens incl. the current one
    *,
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Launch the paged decode attention kernel: ``paged_tc_kernel`` for
    bf16 (then ``merge_kernel`` when the keys are split), ``decode_kernel``
    for fp32.  Returns (B, H, D) in the dtype of ``q``.
    ``paged_attention.launches`` counts the calls that launched a kernel,
    ``paged_attention.merge_launches`` the merge launches among them."""
    tensors = (q, k_pool, v_pool, block_tables, seq_lens)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("paged_attention: all tensors must be on one CUDA device")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"paged_attention: q/k/v must share float32 or bfloat16, got "
                         f"{q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("paged_attention: block_tables and seq_lens must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention: all tensors must be contiguous")
    b, h, d = q.shape
    n, page, hkv, dk = k_pool.shape
    if (
        v_pool.shape != k_pool.shape or dk != d or h % hkv
        or block_tables.ndim != 2 or block_tables.shape[0] != b
        or seq_lens.shape != (b,)
    ):
        raise ValueError(
            f"paged_attention: bad shapes q{tuple(q.shape)} pool{tuple(k_pool.shape)} "
            f"tables{tuple(block_tables.shape)} seq_lens{tuple(seq_lens.shape)}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head dim {d} not in {HEAD_DIMS}")
    g, m = h // hkv, block_tables.shape[1]
    if q.dtype == torch.bfloat16 and (g > MAX_TC_GROUP or m > MAX_TC_TABLE_WIDTH):
        raise ValueError(f"paged_attention: bf16 group {g} > {MAX_TC_GROUP} or table width "
                         f"{m} > {MAX_TC_TABLE_WIDTH}")
    if q.dtype == torch.float32 and (g * d > MAX_GROUP_WIDTH or page > MAX_PAGE):
        raise ValueError(f"paged_attention: fp32 group width {g * d} > "
                         f"{MAX_GROUP_WIDTH} or page {page} > {MAX_PAGE}")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_attention: pools must be 16-byte aligned")
    if q.dtype == torch.bfloat16 and q.data_ptr() % 16:
        raise ValueError("paged_attention: bf16 q must be 16-byte aligned")
    if b > 65535 or hkv > 65535:
        raise ValueError("paged_attention: too many sequences or KV heads for the grid")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    nsplit, split_keys = 1, SPLIT_ROUND
    part_o = part_ml = None
    if q.dtype == torch.bfloat16:
        nsplit, split_keys = decode_splits(b, hkv, m * page, _sm_count(q.device.index))
        if nsplit > 1:  # fp32 partials, from the caching allocator on this stream
            part_o = torch.empty((nsplit, b, h, d), dtype=torch.float32, device=q.device)
            part_ml = torch.empty((nsplit, b, h, 2), dtype=torch.float32, device=q.device)
    # CUDA launches on the calling thread's current device: make it q's
    with torch.cuda.device(q.device):
        rc = _decode_lib()(
            _DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            None if part_o is None else part_o.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            b, h, hkv, d, page, m, nsplit, split_keys,
            float(d) ** -0.5, float(logit_softcap),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"paged_attention: CUDA error {rc} at launch")
    paged_attention.launches += 1
    if nsplit > 1:
        paged_attention.merge_launches += 1
    return out


paged_attention.launches = 0
paged_attention.merge_launches = 0
