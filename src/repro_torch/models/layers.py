"""Layers of the fused paged serving path, in PyTorch.

Counterparts of ``src/repro/models/layers.py``: rmsnorm, split-half RoPE,
the QKV / output projections, the MLP and the fused ragged paged attention.
Layouts are the reference's, so tests compare like with like:
activations (B, T, d_model), projections ``wq (d, H, hd)``, ``wo (H, hd, d)``,
paged pools (num_blocks, block_size, Hkv, D).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops as kernel_ops
from ..kvcache.cache_ops import write_ragged
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
