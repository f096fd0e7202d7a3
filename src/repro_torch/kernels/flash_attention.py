"""Flash attention over contiguous K/V: the wrapper of the hand-written CUDA
kernel ``csrc/flash_attention.cu``, which replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention.py::flash_attention``.

The wrapper takes the layout ``(B, T, H, D)`` as it is, with no transposes:
each tensor's ``(T, H, D)`` part must be contiguous, and the batch stride
is passed to the kernel, so a prefix ``cache[:, :n]`` of a longer cache is
read in place.  It takes CUDA tensors only and launches the kernel or
raises.  Its plain version, ``kernels.ref.flash_attention_ref``, is what
``kernels.ops`` uses for CPU tensors and what the kernel is held against on
the card.

The bf16 kernel reads q, K and V by TMA through three tensor maps, 4-d
views ``{D, H, T, B}`` of the tensors as they lie (K and V with ``Tk`` as
their extent, so rows past it read as zeros, and their own batch stride),
which the C function encodes with ``cuTensorMapEncodeTiled`` at every call
before the launch.  That is host time on every call on top of the
wrapper's own checks; ``chip_smoke.py`` phase 5 prints each call's whole
enqueue time (``enqueue_ms``, encodings included) beside its device time.
The wrapper plans how many query positions a block takes: its rows are
(position, head) pairs of one KV head's group (``block_positions``).
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import flash_attention_ref  # noqa: F401

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the head dims the kernel is built for (80: hubert-xlarge); any other D is
# refused, never sent to the plain version
HEAD_DIMS = (64, 80, 128, 256)


def _lib():
    fn = build.load("flash_attention").flash_attention
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, p, p, p, p, i, i, i, i, i, i, ll, ll, i, i, i, i,
                       ctypes.c_float, ctypes.c_float, p]
        fn.restype = i
    return fn


def block_rows(d: int) -> int:
    """Rows of one block of the bf16 kernel: two consumer warpgroups of 64,
    one at D = 256 (``WgTile::kRows``)."""
    return 64 if d > 128 else 128


def block_positions(group: int, d: int) -> int:
    """Query positions per block of the bf16 kernel: its rows are
    (position, head) pairs of one KV head's group of ``group`` query heads,
    so ``block_rows(d) // group`` positions (the spare rows are never
    stored)."""
    rows = block_rows(d)
    if not 1 <= group <= rows:
        raise ValueError(f"flash_attention: a group of {group} query heads per KV head "
                         f"does not fit the bf16 kernel's {rows} rows at D = {d}")
    return rows // group


def _rows_contiguous(t: torch.Tensor) -> bool:
    """True iff the (T, H, D) part of ``t`` is laid out contiguously."""
    _, n, h, d = t.shape
    return all(size <= 1 or got == want for size, got, want
               in zip((n, h, d), t.stride()[1:], (h * d, d, 1)))


def flash_attention(
    q: torch.Tensor,  # (B, Tq, H, D)
    k: torch.Tensor,  # (B, Tk, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    sliding_window: int = 0,
    q_offset: int = 0,
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Launch the flash attention kernel.  Query row ``t`` sits at absolute
    position ``q_offset + t``, key ``s`` at ``s``.  Returns (B, Tq, H, D) in
    the dtype of ``q``.  ``flash_attention.launches`` counts the launches."""
    tensors = (q, k, v)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q/k/v must share float32 or bfloat16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    b, tq, h, d = q.shape
    bk, tk, hkv, dk = k.shape
    if bk != b or dk != d or hkv == 0 or h % hkv:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} k{tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")
    if q_offset < 0 or sliding_window < 0:
        raise ValueError("flash_attention: q_offset and sliding_window must be >= 0")
    if not all(_rows_contiguous(t) for t in tensors) or (b > 1 and k.stride(0) != v.stride(0)):
        raise ValueError("flash_attention: each (T, H, D) part must be contiguous, "
                         "and k and v must share their batch stride")
    # what TMA needs of a tensor map: a 16-byte aligned base and strides of
    # 16-byte multiples (the row and token strides, D * 2 and H * D * 2
    # bytes, always are; a lone sequence's batch stride is never used)
    elt = q.element_size()
    if any(t.data_ptr() % 16 or (b > 1 and (t.stride(0) * elt) % 16) for t in tensors):
        raise ValueError("flash_attention: pointers and batch strides must be 16-byte aligned")
    if b > 65535 or h > 65535:
        raise ValueError("flash_attention: too many sequences or heads for the grid")
    positions = block_positions(h // hkv, d) if q.dtype == torch.bfloat16 else 0
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    # CUDA launches on the calling thread's current device: make it q's
    with torch.cuda.device(q.device):
        rc = _lib()(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, tq, tk, h, hkv, d, q.stride(0), k.stride(0), positions, int(q_offset),
            int(bool(causal)),
            int(sliding_window), float(d) ** -0.5, float(logit_softcap),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc == -1:
        raise RuntimeError("flash_attention: cuTensorMapEncodeTiled refused a tensor map")
    if rc != 0:
        raise RuntimeError(f"flash_attention: CUDA error {rc} at launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
