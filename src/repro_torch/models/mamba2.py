"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) mixer in PyTorch.

Counterpart of ``src/repro/models/mamba2.py``.  The full-sequence path is
the chunked SSD algorithm: quadratic attention-like products *within*
chunks of ``ssm_chunk`` tokens and a linear scan over the chunk states
*between* them (a Python loop over chunks, where the reference has a
``lax.scan``).  The decode path is the O(1) recurrence.  Both carry an
explicit ``(ssm, conv)`` state pair, constant-size per sequence
(DESIGN.md §4).  The reference computes all of it in plain jnp, outside
any Pallas kernel, so the port is plain PyTorch on both devices
(``torch.einsum`` / ``torch.matmul``): no hand kernel, on the CPU or the
card.

One B/C group (ngroups=1) and a scalar A per head, as in the Mamba-2
paper's default configuration.  ``A = -exp(A_log)``, ``dt = softplus(dt_raw
+ dt_bias)``, the decays and the states are fp32 whatever the model's
dtype; the gate is ``rmsnorm(y * silu(z))``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import rmsnorm

Params = Dict[str, torch.Tensor]


class MambaState(NamedTuple):
    ssm: torch.Tensor  # (B, nh, hd, dstate) fp32
    conv: torch.Tensor  # (B, conv_width - 1, conv_channels), the model dtype


def conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state_size


def init_mamba(cfg: ModelConfig, generator: torch.Generator, dtype, periods: int) -> Params:
    """Random mixer weights stacked over ``periods``, with the reference's
    shapes and scales: ``in_proj`` (P, d, 2 d_inner + 2 dstate + nh) for
    z, x, B, C and dt; the depthwise ``conv_w`` (P, W, C) and ``conv_b``;
    ``A_log`` = log(linspace(1, 16, nh)), ``dt_bias`` 0 and ``D`` 1 in fp32;
    ``norm_w`` and ``out_proj`` (P, d_inner, d)."""
    d, d_in, nh, ds = cfg.d_model, cfg.d_inner, cfg.ssm_num_heads, cfg.ssm_state_size
    w, ch = cfg.ssm_conv_width, conv_channels(cfg)
    dev = generator.device

    def normal(shape, scale):
        return torch.randn((periods,) + shape, generator=generator, device=dev,
                           dtype=dtype).mul_(scale)

    def fill(row, dt):
        return row.to(device=dev, dtype=dt).expand(periods, *row.shape).clone()

    return {
        "in_proj": normal((d, 2 * d_in + 2 * ds + nh), d**-0.5),
        "conv_w": normal((w, ch), w**-0.5),
        "conv_b": torch.zeros((periods, ch), device=dev, dtype=dtype),
        "A_log": fill(torch.log(torch.linspace(1.0, 16.0, nh)), torch.float32),
        "dt_bias": torch.zeros((periods, nh), device=dev, dtype=torch.float32),
        "D": torch.ones((periods, nh), device=dev, dtype=torch.float32),
        "norm_w": torch.ones((periods, d_in), device=dev, dtype=dtype),
        "out_proj": normal((d_in, d), d_in**-0.5),
    }


def zero_state(cfg: ModelConfig, batch: int, dtype=torch.float32, device="cpu") -> MambaState:
    return MambaState(
        ssm=torch.zeros((batch, cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state_size),
                        dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, conv_channels(cfg)), dtype=dtype,
                         device=device),
    )


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    d_in, ds = cfg.d_inner, cfg.ssm_state_size
    return proj[..., :d_in], proj[..., d_in:2 * d_in + 2 * ds], proj[..., 2 * d_in + 2 * ds:]


def _causal_conv_full(
    cfg: ModelConfig, p: Params, xBC: torch.Tensor, conv_init: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time. xBC: (B, T, C); conv_init: (B, W-1, C)."""
    w = cfg.ssm_conv_width
    padded = torch.cat([conv_init.to(xBC.dtype), xBC], dim=1)
    t = xBC.shape[1]
    out = torch.zeros_like(xBC)
    for i in range(w):
        out = out + padded[:, i:i + t, :] * p["conv_w"][i]
    out = F.silu(out + p["conv_b"])
    new_conv = padded[:, padded.shape[1] - (w - 1):, :]
    return out, new_conv


def _ssd_chunked(
    cfg: ModelConfig,
    xh: torch.Tensor,  # (B, T, nh, hd)
    dt: torch.Tensor,  # (B, T, nh) fp32, post-softplus
    A: torch.Tensor,  # (nh,) fp32, negative
    Bm: torch.Tensor,  # (B, T, ds)
    Cm: torch.Tensor,  # (B, T, ds)
    h0: torch.Tensor,  # (B, nh, hd, ds) fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. Returns (y (B, T, nh, hd) in the dtype of ``xh``, the
    final state (B, nh, hd, ds) fp32)."""
    b, t, nh, hd = xh.shape
    ds = Bm.shape[-1]
    L = min(cfg.ssm_chunk, t)
    pad = (-t) % L
    if pad:
        xh, dt, Bm, Cm = (F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
                          for a in (xh, dt, Bm, Cm))
    tp = t + pad
    nc = tp // L

    f32 = torch.float32
    xc = xh.reshape(b, nc, L, nh, hd).to(f32)
    dtc = dt.reshape(b, nc, L, nh)
    bc = Bm.reshape(b, nc, L, ds).to(f32)
    cc = Cm.reshape(b, nc, L, ds).to(f32)

    a = dtc * A  # (B, Nc, L, nh) log-decay, <= 0
    cum = torch.cumsum(a, dim=2)  # inclusive

    # intra-chunk: M[t, s] = exp(cum_t - cum_s) for s <= t; masked before the
    # exp, where s > t would overflow
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, Nc, L_t, L_s, nh)
    causal = torch.ones((L, L), dtype=torch.bool, device=xh.device).tril()
    M = torch.exp(diff.masked_fill(~causal[None, None, :, :, None], -1e30))
    cb = torch.einsum("bnts,bnms->bntm", cc, bc)  # (B, Nc, L_t, L_s)
    scores = cb[..., None] * M * dtc[:, :, None, :, :]  # x dt_s
    y_intra = torch.einsum("bntsh,bnshd->bnthd", scores, xc)

    # chunk states: S_c = sum_s exp(cum_last - cum_s) dt_s B_s (x) x_s
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B, Nc, L, nh)
    weighted_x = xc * (dtc * decay_to_end)[..., None]  # (B, Nc, L, nh, hd)
    S = torch.einsum("bnshd,bnsk->bnhdk", weighted_x, bc)  # (B, Nc, nh, hd, ds)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B, Nc, nh)

    # inter-chunk scan: the state entering each chunk
    h = h0.to(f32)
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * chunk_decay[:, c, :, None, None] + S[:, c]
    h_enter = torch.stack(entering, dim=1)  # (B, Nc, nh, hd, ds)

    y_inter = torch.einsum("bntk,bnhdk,bnth->bnthd", cc, h_enter, torch.exp(cum))
    y = (y_intra + y_inter).reshape(b, tp, nh, hd)[:, :t]
    return y.to(xh.dtype), h


def mamba_full(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # (B, T, d_model)
    state: Optional[MambaState] = None,
) -> Tuple[torch.Tensor, MambaState]:
    """Full-sequence mixer (prefill chunk or whole sequence) from ``state``
    (zeros when None).  Returns (out (B, T, d_model), the new state); the
    state passed in is not modified."""
    b, t, _ = x.shape
    if state is None:
        state = zero_state(cfg, b, x.dtype, x.device)
    proj = x @ p["in_proj"]
    z, xBC, dt_raw = _split_proj(cfg, proj)
    xBC, new_conv = _causal_conv_full(cfg, p, xBC, state.conv)

    d_in, ds = cfg.d_inner, cfg.ssm_state_size
    xs, Bm, Cm = xBC[..., :d_in], xBC[..., d_in:d_in + ds], xBC[..., d_in + ds:]
    nh, hd = cfg.ssm_num_heads, cfg.ssm_head_dim
    xh = xs.reshape(b, t, nh, hd)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    y, h_final = _ssd_chunked(cfg, xh, dt, A, Bm, Cm, state.ssm)
    y = y + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(b, t, d_in).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"], MambaState(ssm=h_final, conv=new_conv)


def mamba_full_ref(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,
    state: Optional[MambaState] = None,
) -> Tuple[torch.Tensor, MambaState]:
    """Sequential-recurrence oracle of the chunked path (tests only)."""
    if state is None:
        state = zero_state(cfg, x.shape[0], x.dtype, x.device)
    outs = []
    for i in range(x.shape[1]):
        y, state = mamba_decode_step(cfg, p, x[:, i:i + 1, :], state)
        outs.append(y)
    return torch.cat(outs, dim=1), state


def mamba_decode_step(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # (B, 1, d_model)
    state: MambaState,
) -> Tuple[torch.Tensor, MambaState]:
    """The O(1) recurrence for one token.  Returns (out (B, 1, d_model), the
    new state); the state passed in is not modified."""
    b = x.shape[0]
    proj = x[:, 0, :] @ p["in_proj"]  # (B, proj_out)
    z, xBC, dt_raw = _split_proj(cfg, proj)

    window = torch.cat([state.conv.to(xBC.dtype), xBC[:, None, :]], dim=1)  # (B, W, C)
    conv_out = torch.einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"]
    xBC = F.silu(conv_out)
    new_conv = window[:, 1:, :]

    d_in, ds = cfg.d_inner, cfg.ssm_state_size
    xs = xBC[..., :d_in]
    Bm = xBC[..., d_in:d_in + ds].float()
    Cm = xBC[..., d_in + ds:].float()
    nh, hd = cfg.ssm_num_heads, cfg.ssm_head_dim
    xh = xs.reshape(b, nh, hd).float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (B, nh)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A)  # (B, nh)

    dBx = torch.einsum("bh,bhd,bk->bhdk", dt, xh, Bm)
    h = state.ssm * decay[:, :, None, None] + dBx
    y = torch.einsum("bk,bhdk->bhd", Cm, h) + xh * p["D"][None, :, None]
    y = y.reshape(b, d_in).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return (y @ p["out_proj"])[:, None, :], MambaState(ssm=h, conv=new_conv)
