"""Paged attention: the wrappers of two hand-written CUDA kernels, each
replacing a Pallas TPU kernel of ``src/repro/kernels/paged_attention.py``:

* ``ragged_paged_attention`` (``csrc/ragged_paged_attention.cu``): the fused
  mixed batch of prefill chunks and decodes; bf16 by ``wgmma`` and TMA page
  loads through the block table, with the keys split across jobs where few
  (sequence, KV head, row tile) jobs would leave the card idle
  (``ragged_splits``);
* ``paged_attention`` (``csrc/paged_attention.cu``): decode, one query token
  per sequence (the split serving path); bf16 on the tensor cores, with
  the keys split across blocks where few (sequence, KV head) pairs would
  leave the card idle (``decode_splits``);
* ``ragged_paged_attention_sharded`` and ``paged_attention_sharded``: the
  two over a tensor-parallel mesh's KV-head shards (DESIGN.md §11), one
  launch of the kernel above per shard on its local heads.

The bf16 ragged kernel reads q and the pools by TMA through tensor maps that
its C function encodes at every call (host time in ``chip_smoke.py``'s
``enqueue_ms``); it takes pages of a multiple of ``RAGGED_PAGE_ALIGN``
tokens and groups of at most ``RAGGED_ROWS`` query heads, and the wrapper
refuses others with a ``ValueError``.

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

from ..distributed.sharding import HeadSharded, over_kv_shards
from ..kvcache.cache_ops import (  # noqa: F401
    paged_attention_ref,
    ragged_paged_attention_ref,
)
from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)
# Shared memory one block may opt into on the H100 (227 KB).
SMEM_LIMIT = 232448


@functools.lru_cache(maxsize=None)
def _table_limit(name: str, dtype: int, d: int, rows: int, page: int) -> int:
    """The widest table (entries per sequence) whose block of kernel
    ``name`` fits ``SMEM_LIMIT``, from the source's own
    ``<name>_smem_bytes(dtype, d, rows, page, m)``: -1 when no width fits
    (the page alone is too large)."""
    fn = getattr(build.load(name), f"{name}_smem_bytes")
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    base = fn(dtype, d, rows, page, 0)
    per_entry = fn(dtype, d, rows, page, 1) - base
    if base > SMEM_LIMIT:
        return -1
    return (SMEM_LIMIT - base) // per_entry if per_entry else 1 << 30


def _check_smem(name: str, dtype: int, d: int, rows: int, page: int, m: int) -> None:
    """Refuse a page or table width whose block of kernel ``name`` would
    not fit."""
    limit = _table_limit(name, dtype, d, rows, page)
    if m > limit:
        raise ValueError(f"{name}: at head dim {d}, {rows} rows and page {page} a block "
                         f"takes a table of at most {max(limit, 0)} entries, got {m}")


def _lib():
    fn = build.load("ragged_paged_attention").ragged_paged_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i,
                       ctypes.c_float, ctypes.c_float, p]
        fn.restype = i
    return fn


# The bf16 ragged kernel (ragged_wg_kernel): jobs of RAGGED_ROWS grouped
# query rows, a row tile being RAGGED_ROWS // G query slots of a KV head's
# G heads; one block per SM holding ragged_pipes(d) pipelines (a producer
# warp and a consumer warpgroup each).  Its K/V boxes are gcd(page, 64) rows
# of one page, so a page must be a multiple of RAGGED_PAGE_ALIGN.
RAGGED_ROWS = 64
RAGGED_PAGE_ALIGN = 8


def ragged_pipes(d: int) -> int:
    """Job pipelines per block of the bf16 ragged kernel: two consumer
    warpgroups beside their producer warps at D <= 128, one at D = 256
    (``RgTile::kPipes``)."""
    return 1 if d > 128 else 2


def ragged_row_tiles(group: int, qmax: int) -> Tuple[int, int]:
    """(query slots per row tile, row tiles per (sequence, KV head)) of the
    bf16 ragged kernel: ``RAGGED_ROWS // group`` slots of ``group`` heads
    each, enough tiles to cover ``qmax`` slots."""
    if not 1 <= group <= RAGGED_ROWS:
        raise ValueError(f"ragged_paged_attention: a group of {group} query heads per KV "
                         f"head does not fit the bf16 kernel's {RAGGED_ROWS} rows")
    positions = RAGGED_ROWS // group
    return positions, max(1, -(-qmax // positions))


def ragged_splits(seqs: int, kv_heads: int, row_tiles: int, max_keys: int,
                  slots: int) -> Tuple[int, int]:
    """(number of splits, keys per split) of a bf16 ragged call over a table
    of ``max_keys`` = M * page keys, from shapes alone (the fused path reads
    nothing back): ``decode_splits``' rule for a kernel whose ``slots``
    pipelines (SMs x ``ragged_pipes``) each take one (sequence, KV head, row
    tile, split) job a round -- as many splits as let every (sequence, KV
    head, row tile) fit one round, at most ``MAX_SPLITS``, each whole rounds
    of 64 keys and no shorter than ``MIN_SPLIT_KEYS``.  Split i covers keys
    [i * keys, (i + 1) * keys); together they cover [0, max_keys) once."""
    rounds = max(1, -(-max_keys // SPLIT_ROUND))
    jobs = max(1, seqs * kv_heads * row_tiles)
    n = max(1, min(slots // jobs, max_keys // MIN_SPLIT_KEYS, MAX_SPLITS))
    keys = SPLIT_ROUND * -(-rounds // n)
    return max(1, -(-max_keys // keys)), keys


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
    """Launch the fused ragged paged-attention kernel: ``ragged_wg_kernel``
    for bf16 (then ``merge_kernel`` when the keys are split,
    ``ragged_splits``), ``ragged_kernel`` for fp32.  Returns (S, Qmax, H, D)
    in the dtype of ``q``.  ``ragged_paged_attention.launches`` counts the
    calls that launched a kernel, ``.merge_launches`` the merge launches
    among them, and ``.last_splits`` is (splits, keys per split) of the
    latest launch.  Shapes, dtypes and the page size are checked before the
    device, so a call the kernel cannot take raises on any tensor."""
    tensors = (q, k_pool, v_pool, block_tables, q_positions, kv_lens)
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
    m = block_tables.shape[1]
    g = h // hkv
    bf16 = q.dtype == torch.bfloat16
    if bf16 and page % RAGGED_PAGE_ALIGN:
        raise ValueError(f"ragged_paged_attention: bf16 pages must be a multiple of "
                         f"{RAGGED_PAGE_ALIGN} tokens, got {page}")
    row_tiles = ragged_row_tiles(g, qmax)[1] if bf16 else 1
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("ragged_paged_attention: all tensors must be on one CUDA device")
    _check_smem("ragged_paged_attention", _DTYPES[q.dtype], d, qmax * g, page, m)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    nsplit, split_keys = 1, m * page
    part_o = part_ml = None
    if bf16:
        nsplit, split_keys = ragged_splits(
            s, hkv, row_tiles, m * page, _sm_count(q.device.index) * ragged_pipes(d))
        if nsplit > 1:  # fp32 partials, from the caching allocator on this stream
            part_o = torch.empty((nsplit, s, qmax, h, d), dtype=torch.float32, device=q.device)
            part_ml = torch.empty((nsplit, s, qmax, h, 2), dtype=torch.float32,
                                  device=q.device)
    # CUDA launches on the calling thread's current device: make it q's
    with torch.cuda.device(q.device):
        rc = _lib()(
            _DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), q_positions.data_ptr(), kv_lens.data_ptr(),
            out.data_ptr(), None if part_o is None else part_o.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            s, qmax, h, hkv, d, page, n, m, nsplit, split_keys,
            float(d) ** -0.5, float(logit_softcap),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc == -1:
        raise RuntimeError("ragged_paged_attention: cuTensorMapEncodeTiled refused a tensor map")
    if rc != 0:
        raise RuntimeError(f"ragged_paged_attention: CUDA error {rc} at launch")
    ragged_paged_attention.launches += 1
    if nsplit > 1:
        ragged_paged_attention.merge_launches += 1
    ragged_paged_attention.last_splits = (nsplit, split_keys)
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.merge_launches = 0
ragged_paged_attention.last_splits = None


# fp32 (decode_kernel) keeps G * D fp32 accumulators in registers across
# its 128 threads (at most 32 each), and a ring of pages in shared memory; a
# larger G * D, or a page whose ring does not fit, is refused.
MAX_GROUP_WIDTH = 4096
# bf16 (paged_tc_kernel) holds the G query heads of a KV head in its 4
# warps of 16 rows and the table row in shared memory, and takes any page
# size; a larger G, or a table whose row does not fit, is refused.
MAX_TC_GROUP = 64
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
    ``paged_attention.merge_launches`` the merge launches among them, and
    ``paged_attention.last_splits`` is (splits, keys per split) of the
    latest launch."""
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
    if q.dtype == torch.bfloat16 and g > MAX_TC_GROUP:
        raise ValueError(f"paged_attention: bf16 group {g} > {MAX_TC_GROUP}")
    if q.dtype == torch.float32 and g * d > MAX_GROUP_WIDTH:
        raise ValueError(f"paged_attention: fp32 group width {g * d} > {MAX_GROUP_WIDTH}")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_attention: pools must be 16-byte aligned")
    if q.dtype == torch.bfloat16 and q.data_ptr() % 16:
        raise ValueError("paged_attention: bf16 q must be 16-byte aligned")
    if b > 65535 or hkv > 65535:
        raise ValueError("paged_attention: too many sequences or KV heads for the grid")
    _check_smem("paged_attention", _DTYPES[q.dtype], d, g, page, m)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    nsplit, split_keys = 1, m * page
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
    paged_attention.last_splits = (nsplit, split_keys)
    return out


paged_attention.launches = 0
paged_attention.merge_launches = 0
paged_attention.last_splits = None


# ---------------------------------------------------------------------------
# Over a tensor-parallel mesh's KV-head shards (DESIGN.md §11)
#
# Replace ``ragged_paged_attention_sharded`` and ``paged_attention_sharded``
# (src/repro/kernels/paged_attention.py), a ``shard_map`` of the Pallas
# kernels over the mesh's ``model`` axis with no collective inside.  Here
# each shard launches the hand-written kernel above on its own device, on
# its local Hkv / tp KV heads and their query heads: the query-head axis is
# grouped KV-head-major, so a contiguous run of H / tp query heads holds the
# G queries of each local KV head.  Tables, positions and lengths
# replicate; the outputs are gathered along heads onto q's device.  When
# the head counts do not divide tp the pool is replicated and one
# unsharded call runs on shard 0's copy, as the reference falls back.
# ---------------------------------------------------------------------------


def _count(wrapper, shards: int) -> None:
    wrapper.launches += 1
    wrapper.shard_launches += shards
    wrapper.fallbacks += shards == 0


def ragged_paged_attention_sharded(
    q: torch.Tensor,  # (S, Qmax, H, D) on the mesh's lead device
    k_pool: HeadSharded,  # (N, page, Hkv, D) over the mesh
    v_pool: HeadSharded,
    block_tables: torch.Tensor,  # (S, M) int32
    q_positions: torch.Tensor,  # (S, Qmax) int32
    kv_lens: torch.Tensor,  # (S,) int32
    mesh,
    *,
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """``ragged_paged_attention`` over the mesh's KV-head shards: one launch
    per shard on CUDA tensors (or one unsharded launch where the heads do not
    divide).  Returns (S, Qmax, H, D) on q's device.  ``.launches`` counts
    the calls, ``.shard_launches`` the per-shard launches among them and
    ``.fallbacks`` the unsharded ones."""
    if q.device.type != "cuda":
        raise ValueError("ragged_paged_attention_sharded: q must be on a CUDA device")
    out, n = over_kv_shards(ragged_paged_attention, q, k_pool, v_pool,
                            (block_tables, q_positions, kv_lens), mesh, 2,
                            logit_softcap=logit_softcap)
    _count(ragged_paged_attention_sharded, n)
    return out


def ragged_paged_attention_sharded_ref(q, k_pool, v_pool, block_tables, q_positions,
                                       kv_lens, mesh, *, logit_softcap=0.0):
    """Plain version of ``ragged_paged_attention_sharded``: the plain
    version per shard, gathered."""
    return over_kv_shards(ragged_paged_attention_ref, q, k_pool, v_pool,
                          (block_tables, q_positions, kv_lens), mesh, 2,
                          logit_softcap=logit_softcap)[0]


def paged_attention_sharded(
    q: torch.Tensor,  # (B, H, D) on the mesh's lead device
    k_pool: HeadSharded,  # (N, page, Hkv, D) over the mesh
    v_pool: HeadSharded,
    block_tables: torch.Tensor,  # (B, M) int32
    seq_lens: torch.Tensor,  # (B,) int32
    mesh,
    *,
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """``paged_attention`` over the mesh's KV-head shards, counted as
    ``ragged_paged_attention_sharded`` is.  Each shard's bf16 call picks its
    own key splits from its local KV heads (``decode_splits``)."""
    if q.device.type != "cuda":
        raise ValueError("paged_attention_sharded: q must be on a CUDA device")
    out, n = over_kv_shards(paged_attention, q, k_pool, v_pool, (block_tables, seq_lens),
                            mesh, 1, logit_softcap=logit_softcap)
    _count(paged_attention_sharded, n)
    return out


def paged_attention_sharded_ref(q, k_pool, v_pool, block_tables, seq_lens, mesh, *,
                                logit_softcap=0.0):
    """Plain version of ``paged_attention_sharded``."""
    return over_kv_shards(paged_attention_ref, q, k_pool, v_pool, (block_tables, seq_lens),
                          mesh, 1, logit_softcap=logit_softcap)[0]


for _fn in (ragged_paged_attention_sharded, paged_attention_sharded):
    _fn.launches = _fn.shard_launches = _fn.fallbacks = 0
