"""Plain PyTorch versions of the kernels over contiguous K/V.

Counterpart of ``src/repro/kernels/ref.py``: what ``kernels.ops`` uses for
CPU tensors and what the hand-written CUDA kernels are held against on the
card.  The paged kernels' plain versions live beside the paged layout, in
``kvcache/cache_ops.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kvcache.cache_ops import NEG_INF


def flash_attention_ref(
    q: torch.Tensor,  # (B, Tq, H, D)
    k: torch.Tensor,  # (B, Tk, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    sliding_window: int = 0,
    q_offset: int = 0,
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Dense attention with fp32 scores.  Query row ``t`` sits at absolute
    position ``q_offset + t`` and key ``s`` at ``s``; causal keeps
    ``s <= q_pos``, a sliding window keeps ``s > q_pos - window``.  The
    softcap (``tanh(x / cap) * cap``) is applied before the mask; masked
    scores are -1e30.  A row that keeps no key is 0 (the safe divisor of
    the Pallas kernel).  GQA: query head ``h`` reads KV head ``h // G``.
    Returns (B, Tq, H, D) in the dtype of ``q``."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, tq, hkv, h // hkv, d).float()
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) * (d**-0.5)
    if logit_softcap:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    qp = q_offset + torch.arange(tq, device=q.device)[:, None]
    kp = torch.arange(tk, device=q.device)[None, :]
    keep = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        keep = keep & (kp <= qp)
    if sliding_window:
        keep = keep & (kp > qp - sliding_window)
    probs = F.softmax(scores.masked_fill(~keep, NEG_INF), dim=-1)
    probs = probs * keep.any(dim=-1)[:, None]
    out = torch.einsum("bhgts,bshd->bthgd", probs, v.float())
    return out.reshape(b, tq, h, d).to(q.dtype)
