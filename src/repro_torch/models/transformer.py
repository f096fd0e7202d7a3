"""The decoder stack in PyTorch: the paged serving paths, the contiguous
fallback and ``forward_full``.

Counterpart of ``src/repro/models/transformer.py``: the fused ragged batch
(DESIGN.md §12), the split per-family prefill chunk and decode step
(``RealEngineConfig(fused_batch=False)``), and on contiguous per-request
caches ``forward_full``, ``prefill_chunk``, ``decode_step`` and
``run_segment`` (``RealEngineConfig(backend="contiguous")``).  Parameters
keep the reference's nested-dict layout with period-major stacking: every
leaf under ``params["layers"][str(i)]`` has a leading ``num_periods`` axis,
and so do the paged pools and the contiguous caches.  Two changes from the
reference: the ``lax.scan`` over periods is a Python loop, and pools and
caches are updated in place (the layer views ``pools[i][kv][period]`` and
``caches[i][leaf][period]`` are written), where the reference slices,
updates and merges functional copies.

Only architectures whose every layer is plain causal full attention with a
dense MLP run here; the other families (SSM, MoE, cross-attention, sliding
windows, encoders, VLMs) are ROADMAP Queue 1's item on the contiguous
fallback's other archs.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .config import FFN_DENSE, MIXER_ATTN, ModelConfig
from .layers import (
    KVCache,
    RaggedMeta,
    apply_rope,
    cached_attention,
    dense_attention,
    mlp,
    paged_decode_attention,
    paged_prefill_attention,
    paged_ragged_attention,
    project_qkv,
    rmsnorm,
    write_kv,
)

PyTree = Any
# where the refusals of the other architectures point
ARCHS_ITEM = "ROADMAP Queue 1: the contiguous fallback's other archs"


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
            f"{cfg.name}: the port runs only dense causal full-attention "
            "stacks, paged or contiguous (SSM, MoE, cross-attention, sliding "
            f"windows, encoders and VLMs: {ARCHS_ITEM})"
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


def cache_capacity(cfg: ModelConfig, max_seq: int) -> int:
    return min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq


def init_caches(
    cfg: ModelConfig,
    batch: int,
    max_seq: int,
    dtype=torch.float32,
    device="cpu",
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Contiguous per-pattern-position caches, each leaf stacked over
    periods: ``{"k", "v"}`` (P, B, C, Hkv, D) and ``"pos"`` (P, B, C),
    -1 for empty slots."""
    caches = {}
    cap = cache_capacity(cfg, max_seq)
    for i, spec in enumerate(cfg.layer_pattern()):
        if spec.mixer != MIXER_ATTN:
            raise NotImplementedError(
                f"{cfg.name}: {spec.mixer} caches are not ported yet "
                f"({ARCHS_ITEM})"
            )
        one = KVCache.init(batch, cap, cfg.num_kv_heads, cfg.resolved_head_dim,
                           dtype, device)
        caches[str(i)] = {
            k: v[None].repeat((cfg.num_periods,) + (1,) * v.ndim) for k, v in one.items()
        }
    return caches


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


def _period(tree: Optional[PyTree], per: int) -> Optional[PyTree]:
    """One period's slice of a period-stacked tree (views, no copies)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _period(v, per) for k, v in tree.items()}
    return tree[per]


PAGED_MODES = ("ragged", "prefill", "decode")
CONTIGUOUS_MODES = ("full", "prefill", "decode")


def run_periods(
    cfg: ModelConfig,
    layer_params: PyTree,  # period-stacked params["layers"]
    lo: int,
    num: int,
    x: torch.Tensor,  # (1, T, d) ragged; (B, L, d) prefill / full; (B, 1, d) decode
    caches: Optional[Dict[str, PyTree]],  # period-stacked pools or caches, in place
    block_tables: Optional[torch.Tensor],  # None: contiguous caches
    positions: torch.Tensor,  # same leading shape as x
    meta: Optional[RaggedMeta] = None,  # the fused ragged batch's addressing
    mode: str = "ragged",
    *,
    valid: Optional[torch.Tensor] = None,  # (B, L) padding mask (contiguous)
    q_offsets: Optional[Sequence[int]] = None,  # host chunk offsets (contiguous)
) -> torch.Tensor:
    """Periods [lo, lo + num) of the stack; returns x.

    Paged (``block_tables`` given), ``mode`` picks each layer's attention:
    the fused ragged batch (with ``meta``), or the split path's prefill
    chunk or one-token decode.  Contiguous (``block_tables`` None):
    ``full`` runs the whole sequence with no prior context and, when
    ``caches`` is given, emits them (writes the roped K/V); ``prefill`` and
    ``decode`` attend through the caches (``cached_attention``)."""
    paged = block_tables is not None
    if paged and ((mode == "ragged") != (meta is not None) or mode not in PAGED_MODES):
        raise ValueError(f"paged mode {mode!r} with meta={meta is not None}")
    if not paged and (meta is not None or mode not in CONTIGUOUS_MODES
                      or (caches is None and mode != "full")):
        raise ValueError(f"contiguous mode {mode!r} with caches={caches is not None}")
    pattern = cfg.layer_pattern()
    for per in range(lo, lo + num):
        for i, _spec in enumerate(pattern):
            lp = _period(layer_params[str(i)], per)
            cache = _period(caches[str(i)], per) if caches is not None else None
            h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
            if paged and mode == "ragged":
                mix, _ = paged_ragged_attention(
                    cfg, lp["mixer"], h, cache, block_tables, positions, meta
                )
            elif paged:
                attn = paged_decode_attention if mode == "decode" else paged_prefill_attention
                mix, _ = attn(cfg, lp["mixer"], h, cache, block_tables, positions)
            elif mode == "full":
                mix = dense_attention(cfg, lp["mixer"], h, positions)
                if cache is not None:  # emit the caches: the roped K/V
                    _, k, v = project_qkv(cfg, lp["mixer"], h)
                    k = apply_rope(k, positions, cfg.rope_theta)
                    write_kv(cache, k, v, positions, valid)
            else:
                mix, _ = cached_attention(cfg, lp["mixer"], h, cache, positions,
                                          valid, q_offsets)
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
# Contiguous entry points (per-request caches; RealEngineConfig(
# backend="contiguous")) and the whole-sequence forward
# ---------------------------------------------------------------------------


def forward_full(
    cfg: ModelConfig,
    params: PyTree,
    inputs: torch.Tensor,  # (B, T) tokens
    *,
    emit_caches: bool = False,
    max_seq: Optional[int] = None,
    cache_dtype=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, PyTree]], torch.Tensor]:
    """Whole-sequence forward.  Returns ((B, T, V) fp32 logits, caches of
    capacity ``max_seq or T`` holding the sequence when ``emit_caches``,
    else None, and the auxiliary loss, 0 for the dense stacks the port
    runs).  Every layer's attention is the flash attention over the whole
    sequence (the kernel on CUDA)."""
    _check_supported(cfg)
    x = embed(cfg, params, inputs)
    b, t = inputs.shape
    positions = torch.arange(t, dtype=torch.int32, device=x.device).expand(b, t)
    caches = (
        init_caches(cfg, b, max_seq or t, cache_dtype or x.dtype, x.device)
        if emit_caches else None
    )
    x = run_periods(cfg, params["layers"], 0, cfg.num_periods, x, caches, None,
                    positions, mode="full")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return lm_head(cfg, params, x), caches, aux


def _chunk_positions(offsets: Sequence[int], length: int, device) -> torch.Tensor:
    """(B, L) positions ``offsets[b] + j``, built on the device from host
    integers (no read-back)."""
    ar = torch.arange(length, dtype=torch.int32, device=device)
    offs = [int(o) for o in offsets]
    if len(set(offs)) == 1:
        return (ar + offs[0]).expand(len(offs), length)
    return torch.tensor(offs, dtype=torch.int32).to(device)[:, None] + ar[None, :]


def prefill_chunk(
    cfg: ModelConfig,
    params: PyTree,
    tokens: torch.Tensor,  # (B, L) chunk tokens
    caches: Dict[str, PyTree],  # updated in place
    offsets: Sequence[int],  # (B,) host ints: tokens already prefilled per row
    *,
    lengths: Optional[torch.Tensor] = None,  # (B,) valid tokens in this chunk
) -> Tuple[torch.Tensor, Dict[str, PyTree]]:
    """Chunked prefill on contiguous caches.  Returns ((B, V) logits of each
    row's last valid token, caches updated in place).  ``offsets`` are host
    integers (the reference takes a device array): the engine knows them,
    and the flash kernel's ``q_offset`` needs them without a read-back."""
    _check_supported(cfg)
    x = embed(cfg, params, tokens)
    b, l = tokens.shape
    positions = _chunk_positions(offsets, l, x.device)
    valid = None
    if lengths is not None:
        valid = torch.arange(l, device=x.device)[None, :] < lengths[:, None]
    x = run_periods(cfg, params["layers"], 0, cfg.num_periods, x, caches, None,
                    positions, mode="prefill", valid=valid, q_offsets=offsets)
    if lengths is None:
        xl = x[:, -1:, :]
    else:
        last = (lengths.long() - 1).clamp(min=0)
        xl = x[torch.arange(b, device=x.device), last][:, None, :]
    return lm_head(cfg, params, xl)[:, 0, :], caches


def decode_step(
    cfg: ModelConfig,
    params: PyTree,
    last_tokens: torch.Tensor,  # (B,) int32
    caches: Dict[str, PyTree],  # updated in place
    seq_lens: torch.Tensor,  # (B,) current lengths (the new token's position)
) -> Tuple[torch.Tensor, Dict[str, PyTree]]:
    """One decode iteration on contiguous caches (plain masked attention
    over the cache, as in the reference).  Returns ((B, V) logits, caches
    updated in place)."""
    _check_supported(cfg)
    x = embed(cfg, params, last_tokens[:, None])
    x = run_periods(cfg, params["layers"], 0, cfg.num_periods, x, caches, None,
                    seq_lens[:, None], mode="decode")
    return lm_head(cfg, params, x)[:, 0, :], caches


def slice_periods(tree: PyTree, lo: int, hi: int) -> PyTree:
    """Periods [lo, hi) of a period-stacked tree, as views."""
    if isinstance(tree, dict):
        return {k: slice_periods(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]


def merge_periods(tree: PyTree, update: PyTree, lo: int, hi: int) -> PyTree:
    """Write ``update`` into periods [lo, hi) of ``tree`` in place and return
    ``tree``; an update that is that very slice (written in place through
    ``slice_periods`` views) is not copied onto itself."""
    if isinstance(tree, dict):
        for k in tree:
            merge_periods(tree[k], update[k], lo, hi)
        return tree
    dst = tree[lo:hi]
    if not (dst.data_ptr() == update.data_ptr() and dst.shape == update.shape
            and dst.stride() == update.stride()):
        dst.copy_(update)
    return tree


def run_segment(
    cfg: ModelConfig,
    params: PyTree,
    seg: int,
    x: torch.Tensor,
    caches: Optional[Dict[str, PyTree]],
    *,
    mode: str,
    positions: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    q_offsets: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, PyTree]]]:
    """One preemptible segment (periods [lo, hi)) on contiguous caches.
    The caches are updated in place; the engine runs it on a stacked copy
    of its per-request caches, so an aborted decode leaves them untouched."""
    lo, hi = segment_bounds(cfg, seg)
    lp = slice_periods(params["layers"], lo, hi)
    cs = slice_periods(caches, lo, hi) if caches is not None else None
    x = run_periods(cfg, lp, 0, hi - lo, x, cs, None, positions, mode=mode,
                    valid=valid, q_offsets=q_offsets)
    if caches is not None:
        merge_periods(caches, cs, lo, hi)
    return x, caches


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
