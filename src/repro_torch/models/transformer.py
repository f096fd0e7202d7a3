"""The decoder stack on the paged serving paths, in PyTorch.

Counterpart of the paged entry points of ``src/repro/models/transformer.py``:
the fused ragged batch (DESIGN.md §12) and the split per-family prefill
chunk and decode step (``RealEngineConfig(fused_batch=False)``).  Parameters keep the reference's nested-dict layout with
period-major stacking: every leaf under ``params["layers"][str(i)]`` has a
leading ``num_periods`` axis, and so do the paged pools.  Two changes from
the reference: the ``lax.scan`` over periods is a Python loop, and the
pools are updated in place (the layer views ``pools[i][kv][period]`` are
written by ``cache_ops.write_ragged``), where the reference slices,
updates and merges functional copies.

Only architectures whose every layer is plain causal attention with a dense
MLP run here; the contiguous fallback and the other families are
ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from .config import FFN_DENSE, MIXER_ATTN, ModelConfig
from .layers import (
    RaggedMeta,
    mlp,
    paged_decode_attention,
    paged_prefill_attention,
    paged_ragged_attention,
    rmsnorm,
)

PyTree = Any


def supports_paged(cfg: ModelConfig) -> bool:
    """True iff every layer holds plain causal full-attention KV."""
    return (
        cfg.causal
        and not cfg.has_ssm_state
        and not cfg.cross_attn_period
        and not cfg.sliding_window
        and all(s.mixer == MIXER_ATTN for s in cfg.layer_pattern())
    )


def _check_supported(cfg: ModelConfig) -> None:
    if not supports_paged(cfg) or any(
        s.ffn != FFN_DENSE for s in cfg.layer_pattern()
    ) or not cfg.embed_inputs or cfg.vision_dim:
        raise NotImplementedError(
            f"{cfg.name}: the port runs only dense causal-attention stacks "
            "on the paged path (other families: ROADMAP Queue 1 item 9)"
        )


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(
    cfg: ModelConfig, generator: torch.Generator, dtype=torch.float32
) -> PyTree:
    """Random weights with the reference's shapes, scales and stacking, drawn
    from ``generator`` on its device (``torch.Generator`` draws differ from
    ``jax.random``: tests share weights through ``repro_torch.bridge``)."""
    _check_supported(cfg)
    dev = generator.device

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, device=dev, dtype=dtype)
        return w.mul_(scale)

    def zeros(shape):
        return torch.zeros(shape, device=dev, dtype=dtype)

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    d, hd, P = cfg.d_model, cfg.resolved_head_dim, cfg.num_periods
    h, hkv, ff = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    params: Dict[str, PyTree] = {
        "embed": normal((cfg.vocab_size, d), 0.02),
        "final_norm": ones((d,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), d**-0.5)
    layers = {}
    for i, _spec in enumerate(cfg.layer_pattern()):
        mixer = {
            "wq": normal((P, d, h, hd), d**-0.5),
            "wk": normal((P, d, hkv, hd), d**-0.5),
            "wv": normal((P, d, hkv, hd), d**-0.5),
            "wo": normal((P, h, hd, d), (h * hd) ** -0.5),
        }
        if cfg.qkv_bias:
            mixer.update(bq=zeros((P, h, hd)), bk=zeros((P, hkv, hd)),
                         bv=zeros((P, hkv, hd)))
        if cfg.o_bias:
            mixer["bo"] = zeros((P, d))
        layer = {"norm1": ones((P, d)), "norm2": ones((P, d)), "mixer": mixer}
        if ff:
            ffn = {
                "w_up": normal((P, d, ff), d**-0.5),
                "w_down": normal((P, ff, d), ff**-0.5),
            }
            if cfg.activation in ("swiglu", "geglu"):
                ffn["w_gate"] = normal((P, d, ff), d**-0.5)
            if cfg.mlp_bias:
                ffn.update(b_up=zeros((P, ff)), b_down=zeros((P, d)))
            layer["ffn"] = ffn
        else:
            del layer["norm2"]
        layers[str(i)] = layer
    params["layers"] = layers
    return params


def init_paged_pools(
    cfg: ModelConfig,
    num_blocks: int,
    block_size: int,
    dtype=torch.float32,
    device="cpu",
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Shared physical KV pools, one {"k","v"} pair per pattern position,
    each (num_periods, num_blocks, block_size, Hkv, D)."""
    if not supports_paged(cfg):
        raise ValueError(f"{cfg.name}: paged pools require plain causal KV")
    shape = (cfg.num_periods, num_blocks, block_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {
        str(i): {"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)}
        for i, _ in enumerate(cfg.layer_pattern())
    }


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed(cfg: ModelConfig, params: PyTree, inputs: torch.Tensor) -> torch.Tensor:
    """tokens (B, T) int -> (B, T, d)."""
    return params["embed"][inputs.long()]


def lm_head(cfg: ModelConfig, params: PyTree, x: torch.Tensor) -> torch.Tensor:
    """Final norm, the head (``embed.T`` when tied), softcap; fp32 logits."""
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if "lm_head" in params:
        logits = x @ params["lm_head"]
    else:
        logits = x @ params["embed"].T
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits.float()


def ragged_lm_head(
    cfg: ModelConfig,
    params: PyTree,
    x: torch.Tensor,  # (1, T, d) flattened ragged activations
    logit_index: torch.Tensor,  # (S,)
) -> torch.Tensor:
    """Logits of each sequence's last real token: (S, V)."""
    xl = x[0][logit_index.long()][:, None, :]
    return lm_head(cfg, params, xl)[:, 0, :]


# ---------------------------------------------------------------------------
# Layer stack
# ---------------------------------------------------------------------------


def _period(tree: PyTree, per: int) -> PyTree:
    """One period's slice of a period-stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _period(v, per) for k, v in tree.items()}
    return tree[per]


def run_periods(
    cfg: ModelConfig,
    layer_params: PyTree,  # period-stacked params["layers"]
    lo: int,
    num: int,
    x: torch.Tensor,  # (1, T, d) ragged; (B, L, d) prefill; (B, 1, d) decode
    pools: Dict[str, PyTree],  # period-stacked pools, updated in place
    block_tables: torch.Tensor,
    positions: torch.Tensor,  # same leading shape as x
    meta: Optional[RaggedMeta] = None,  # the fused ragged batch's addressing
    mode: str = "ragged",  # "ragged" | "prefill" | "decode"
) -> torch.Tensor:
    """Periods [lo, lo + num) of the paged stack; returns x.  ``mode``
    picks each layer's attention: the fused ragged batch (with ``meta``),
    or the split path's prefill chunk or one-token decode."""
    if (mode == "ragged") != (meta is not None) or mode not in (
        "ragged", "prefill", "decode"
    ):
        raise ValueError(f"mode {mode!r} with meta={meta is not None}")
    pattern = cfg.layer_pattern()
    for per in range(lo, lo + num):
        for i, _spec in enumerate(pattern):
            lp = _period(layer_params[str(i)], per)
            pool = _period(pools[str(i)], per)  # in-place views of the pools
            h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
            if mode == "ragged":
                mix, _ = paged_ragged_attention(
                    cfg, lp["mixer"], h, pool, block_tables, positions, meta
                )
            else:
                attn = paged_decode_attention if mode == "decode" else paged_prefill_attention
                mix, _ = attn(cfg, lp["mixer"], h, pool, block_tables, positions)
            x = x + mix
            if "ffn" in lp:
                x = x + mlp(cfg, lp["ffn"], rmsnorm(x, lp["norm2"], cfg.norm_eps))
    return x


def run_tokens_paged(
    cfg: ModelConfig,
    params: PyTree,
    tokens: torch.Tensor,  # (T,) flattened ragged token batch (bucket-padded)
    pools: Dict[str, PyTree],
    block_tables: torch.Tensor,  # (S, M) physical block ids per sequence
    positions: torch.Tensor,  # (T,) absolute position of each flat token
    meta: RaggedMeta,
    logit_index: torch.Tensor,  # (S,) flat index of each sequence's last token
) -> Tuple[torch.Tensor, Dict[str, PyTree]]:
    """Whole-stack fused mixed-batch forward. Returns ((S, V) logits, pools);
    the pools are the argument, updated in place."""
    _check_supported(cfg)
    x = embed(cfg, params, tokens[None])
    x = run_periods(cfg, params["layers"], 0, cfg.num_periods, x, pools,
                    block_tables, positions[None], meta)
    return ragged_lm_head(cfg, params, x, logit_index), pools


def run_tokens_paged_at(
    cfg: ModelConfig,
    params: PyTree,
    seg_periods: int,  # periods in this segment
    lo: int,  # starting period
    x: torch.Tensor,  # (1, T, d) flattened ragged activations
    pools: Dict[str, PyTree],
    block_tables: torch.Tensor,  # (S, M)
    positions: torch.Tensor,  # (1, T)
    meta: RaggedMeta,
) -> Tuple[torch.Tensor, Dict[str, PyTree]]:
    """One K-layer segment of the fused ragged batch.  Pool writes of an
    aborted iteration land at not-yet-committed positions and are rewritten
    verbatim on re-execution (§12 abort soundness)."""
    x = run_periods(cfg, params["layers"], lo, seg_periods, x, pools,
                    block_tables, positions, meta)
    return x, pools


# ---------------------------------------------------------------------------
# Split per-family entry points (RealEngineConfig(fused_batch=False)): the
# differential oracle of the fused path
# ---------------------------------------------------------------------------


def prefill_chunk_paged(
    cfg: ModelConfig,
    params: PyTree,
    tokens: torch.Tensor,  # (B, L) chunk tokens (L may be bucket-padded)
    pools: Dict[str, PyTree],
    block_tables: torch.Tensor,  # (B, M) physical block ids
    offsets: torch.Tensor,  # (B,) tokens already prefilled per sequence
    last_index: Optional[torch.Tensor] = None,  # (B,) logits position
) -> Tuple[torch.Tensor, Dict[str, PyTree]]:
    """Chunked prefill on the paged layout.  Returns ((B, V) logits of each
    row's ``last_index`` token, or of its last token, and the pools, updated
    in place).  Padded positions write junk KV only into slots rewritten
    before they are read, into the scratch row, or past the table (dropped)."""
    _check_supported(cfg)
    x = embed(cfg, params, tokens)
    b, l = tokens.shape
    positions = offsets[:, None] + torch.arange(l, dtype=offsets.dtype,
                                                device=offsets.device)[None, :]
    x = run_periods(cfg, params["layers"], 0, cfg.num_periods, x, pools,
                    block_tables, positions, mode="prefill")
    if last_index is None:
        xl = x[:, -1:, :]
    else:
        xl = x[torch.arange(b, device=x.device), last_index.long()][:, None, :]
    return lm_head(cfg, params, xl)[:, 0, :], pools


def decode_step_paged(
    cfg: ModelConfig,
    params: PyTree,
    last_tokens: torch.Tensor,  # (B,) int32
    pools: Dict[str, PyTree],
    block_tables: torch.Tensor,  # (B, M)
    seq_lens: torch.Tensor,  # (B,) current lengths (the new token's position)
) -> Tuple[torch.Tensor, Dict[str, PyTree]]:
    """One decode iteration on the paged layout.  Returns ((B, V) logits,
    pools updated in place)."""
    _check_supported(cfg)
    x = embed(cfg, params, last_tokens[:, None])
    x = run_periods(cfg, params["layers"], 0, cfg.num_periods, x, pools,
                    block_tables, seq_lens[:, None], mode="decode")
    return lm_head(cfg, params, x)[:, 0, :], pools


def run_segment_paged_at(
    cfg: ModelConfig,
    params: PyTree,
    seg_periods: int,  # periods in this segment
    lo: int,  # starting period
    x: torch.Tensor,  # (B, 1, d)
    pools: Dict[str, PyTree],
    block_tables: torch.Tensor,
    positions: torch.Tensor,  # (B, 1)
) -> Tuple[torch.Tensor, Dict[str, PyTree]]:
    """One preemptible decode segment on the paged layout (paper §4.3
    safepoints).  Pool writes of an aborted iteration land at the
    not-yet-committed position and are rewritten verbatim on re-execution."""
    x = run_periods(cfg, params["layers"], lo, seg_periods, x, pools,
                    block_tables, positions, mode="decode")
    return x, pools


def run_segment_paged(
    cfg: ModelConfig,
    params: PyTree,
    seg: int,
    x: torch.Tensor,
    pools: Dict[str, PyTree],
    block_tables: torch.Tensor,
    positions: torch.Tensor,
) -> Tuple[torch.Tensor, Dict[str, PyTree]]:
    """``run_segment_paged_at`` addressed by segment index."""
    lo, hi = segment_bounds(cfg, seg)
    return run_segment_paged_at(cfg, params, hi - lo, lo, x, pools,
                                block_tables, positions)


# ---------------------------------------------------------------------------
# Segmented execution (ConServe preemption safepoints)
# ---------------------------------------------------------------------------


def num_segments(cfg: ModelConfig) -> int:
    periods_per_seg = max(1, cfg.safepoint_interval // cfg.pattern_period)
    return math.ceil(cfg.num_periods / periods_per_seg)


def segment_bounds(cfg: ModelConfig, seg: int) -> Tuple[int, int]:
    pps = max(1, cfg.safepoint_interval // cfg.pattern_period)
    lo = seg * pps
    return lo, min(cfg.num_periods, lo + pps)


def segment_spans(cfg: ModelConfig) -> List[Tuple[int, int]]:
    """``(lo, periods)`` per segment: the engine's dispatch list."""
    spans = []
    for s in range(num_segments(cfg)):
        lo, hi = segment_bounds(cfg, s)
        spans.append((lo, hi - lo))
    return spans
