"""Mixture-of-Experts FFN in PyTorch: a top-k router and capacity-based
expert dispatch.

Counterpart of ``src/repro/models/moe.py``, with its semantics kept: the
router runs in fp32 whatever the model's dtype, the top-k weights are a
softmax over the k chosen experts, and tokens go to static per-expert
buffers of ``capacity`` rows (GShard-style).  ``capacity_factor <= 0`` is
dropless (capacity = the token count: the serving paths, where every path
must compute the same function); a positive factor keeps each expert's
first ``round(n * k / E * factor)`` assignments in token order and drops
the rest (residual passthrough).

The dispatch reads nothing back to the host (no ``one_hot`` or
``bincount``, which check or size their output from the data): positions
come from a cumsum on the device, the buffers are filled by one
``index_add_`` into the flat
``(E * capacity, d)`` view (a dropped assignment adds 0 to a clamped row),
the experts run as batched products over the stacked buffers
(``torch.bmm``, as the reference's einsums; a grouped-GEMM kernel is later
work), and each token's k expert outputs are summed in slot order.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig

Params = Dict[str, torch.Tensor]


def init_moe(cfg: ModelConfig, generator: torch.Generator, dtype, periods: int) -> Params:
    """Random expert and router weights stacked over ``periods``, with the
    reference's shapes and scales: ``router`` (P, d, E) fp32, ``w_up`` and
    ``w_gate`` (P, E, d, f), ``w_down`` (P, E, f, d)."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    dev = generator.device

    def normal(shape, scale, dt=dtype):
        return torch.randn((periods,) + shape, generator=generator, device=dev,
                           dtype=dt).mul_(scale)

    p = {
        "router": normal((d, e), d**-0.5, torch.float32),
        "w_up": normal((e, d, f), d**-0.5),
        "w_down": normal((e, f, d), f**-0.5),
    }
    if cfg.activation in ("swiglu", "geglu"):
        p["w_gate"] = normal((e, d, f), d**-0.5)
    return p


def _one_hot(idx: torch.Tensor, e: int) -> torch.Tensor:
    """(..., E) int32 one-hot rows of expert indices, by comparison."""
    return (idx[..., None] == torch.arange(e, device=idx.device)).to(torch.int32)


def router_topk(
    cfg: ModelConfig, p: Params, x: torch.Tensor, aux: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(indices (N, k), weights (N, k) fp32, aux_loss scalar) for flat x (N, d);
    the aux loss is None when ``aux`` is False (serving never reads it, and
    in eager PyTorch it would cost launches every layer)."""
    logits = x.float() @ p["router"].float()  # (N, E)
    e, k = cfg.num_experts, cfg.experts_per_token
    # a stable sort keeps ties in expert order, as ``jax.lax.top_k`` does (a
    # padded row of zeros ties every expert)
    top_logits, top_idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_logits, top_idx = top_logits[:, :k], top_idx[:, :k]
    weights = torch.softmax(top_logits, dim=-1)  # normalised over the top k
    if not aux:
        return top_idx, weights, None
    # Switch-style load-balance auxiliary loss
    probs = torch.softmax(logits, dim=-1)
    frac_tokens = _one_hot(top_idx, e).sum(dim=1).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return top_idx, weights, e * torch.sum(frac_tokens * frac_probs) * cfg.router_aux_coef


def _experts(cfg: ModelConfig, p: Params, buf: torch.Tensor) -> torch.Tensor:
    """The expert FFN over stacked inputs (E, C, d) -> (E, C, d)."""
    up = torch.bmm(buf, p["w_up"])
    if cfg.activation == "swiglu":
        up = F.silu(torch.bmm(buf, p["w_gate"])) * up
    elif cfg.activation == "geglu":
        up = F.gelu(torch.bmm(buf, p["w_gate"]), approximate="tanh") * up
    else:
        up = F.gelu(up, approximate="tanh")
    return torch.bmm(up, p["w_down"])


def moe_ffn(
    cfg: ModelConfig, p: Params, x: torch.Tensor, capacity_factor: float = 1.25,
    aux: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, T, d) -> (out (B, T, d), aux_loss or None, as ``router_topk``)."""
    b, t, d = x.shape
    n, k, e = b * t, cfg.experts_per_token, cfg.num_experts
    xf = x.reshape(n, d)
    top_idx, weights, aux_loss = router_topk(cfg, p, xf, aux)

    # per-(token, slot) assignment, flattened token-major to (N * k,)
    flat_e = top_idx.reshape(-1)
    flat_w = weights.reshape(-1)
    tok_id = torch.arange(n * k, device=x.device) // k
    # position of each assignment within its expert's buffer, in token order
    pos = (_one_hot(flat_e, e).cumsum(dim=0) - 1).gather(1, flat_e[:, None])[:, 0]

    if capacity_factor <= 0:
        capacity = n  # dropless: top-k experts are distinct per token
    else:
        capacity = max(1, int(round(n * k / e * capacity_factor)))
    keep = pos < capacity
    safe_pos = torch.where(keep, pos, torch.full_like(pos, capacity - 1))
    rows = flat_e * capacity + safe_pos

    # scatter into (E, C, d); overflow adds 0 to its clamped row
    contrib = torch.where(keep[:, None], xf[tok_id], torch.zeros((), dtype=x.dtype,
                                                                  device=x.device))
    buf = torch.zeros((e * capacity, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, rows, contrib)
    down = _experts(cfg, p, buf.view(e, capacity, d)).view(e * capacity, d)

    # gather back with the routing weights (dropped assignments weigh 0)
    w = (flat_w * keep).to(x.dtype)[:, None]
    out = (down.index_select(0, rows) * w).view(n, k, d).sum(dim=1)
    return out.reshape(b, t, d), aux_loss


def moe_ffn_dense_oracle(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Numerical oracle: every expert on every token, combined by the router."""
    b, t, d = x.shape
    xf = x.reshape(-1, d)
    top_idx, weights, _ = router_topk(cfg, p, xf, aux=False)
    n = xf.shape[0]
    down = _experts(cfg, p, xf[None].expand(cfg.num_experts, n, d))  # (E, N, d)
    gathered = down[top_idx.T, torch.arange(n, device=x.device)[None, :]]  # (k, N, d)
    out = torch.sum(gathered * weights.T[:, :, None].to(x.dtype), dim=0)
    return out.reshape(b, t, d)
