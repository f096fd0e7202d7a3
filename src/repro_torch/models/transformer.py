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

The paged entry points take a tensor-parallel serving ``mesh`` (DESIGN.md
§11): the pools are then laid out over its shards by KV heads
(``init_paged_pools(mesh=...)``) and every paged layer runs its KV writes and
attention per shard (``layers``).

Every architecture of the reference runs here: causal decoder stacks with
full or sliding-window attention, Mamba-2 SSM mixers (``models/mamba2.py``,
plain PyTorch as in the reference) and hybrids of the two, VLMs whose
cross-attention layers attend over static image K/V, each with a dense MLP
or a Mixture-of-Experts FFN (``models/moe.py``: dropless on every serving
entry point, capacity factor 1.25 by default on ``forward_full`` and
``run_segment``, as in the reference); and bidirectional encoders
(``causal=False``) over precomputed frame embeddings (``embed_inputs=False``)
through ``forward_full``.  Only plain causal full-attention stacks take the
paged entry points (``supports_paged``); sliding windows keep a ring cache
of ``min(max_seq, window)`` slots, SSM mixers a ``{"ssm", "conv"}`` state
and cross-attention layers a ``{"ck", "cv"}`` image K/V per sequence, on
the contiguous entry points only.  A VLM's image embeds enter at
``forward_full`` or at a sequence's first ``prefill_chunk`` (offset 0),
which writes each cross layer's K/V into its cache; later chunks, decode
steps and segments read them from there.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..distributed import sharding
from . import mamba2, moe
from .config import FFN_MOE, MIXER_ATTN, MIXER_CROSS_ATTN, MIXER_MAMBA, ModelConfig
from .layers import (
    KVCache,
    RaggedMeta,
    apply_rope,
    cached_attention,
    cross_attention,
    dense_attention,
    mlp,
    paged_decode_attention,
    paged_prefill_attention,
    paged_ragged_attention,
    project_cross_kv,
    project_qkv,
    rmsnorm,
    write_kv,
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


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(
    cfg: ModelConfig, generator: torch.Generator, dtype=torch.float32
) -> PyTree:
    """Random weights with the reference's shapes, scales and stacking, drawn
    from ``generator`` on its device (``torch.Generator`` draws differ from
    ``jax.random``: tests share weights through ``repro_torch.bridge``).
    As in the reference: no ``embed`` for precomputed input embeddings
    (``embed_inputs=False``), an ``lm_head`` unless the embeddings are tied
    and exist, a ``vision_proj (vision_dim, d)`` for image embeds, and a
    cross-attention layer's mixer shaped as a self-attention one's."""
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
    params: Dict[str, PyTree] = {}
    if cfg.embed_inputs:
        params["embed"] = normal((cfg.vocab_size, d), 0.02)
    params["final_norm"] = ones((d,))
    if not cfg.tie_embeddings or not cfg.embed_inputs:
        params["lm_head"] = normal((d, cfg.vocab_size), d**-0.5)
    if cfg.vision_dim:
        params["vision_proj"] = normal((cfg.vision_dim, d), cfg.vision_dim**-0.5)
    layers = {}
    for i, spec in enumerate(cfg.layer_pattern()):
        if spec.mixer == MIXER_MAMBA:
            mixer = mamba2.init_mamba(cfg, generator, dtype, P)
        else:
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
        if spec.ffn == FFN_MOE:
            layer["ffn"] = moe.init_moe(cfg, generator, dtype, P)
        elif ff:
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
    mesh=None,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Shared physical KV pools, one {"k","v"} pair per pattern position,
    each (num_periods, num_blocks, block_size, Hkv, D).  With a ``mesh``
    each leaf is a ``sharding.HeadSharded`` over its shards (``device`` is
    then not read): Hkv / tp heads per shard when tp divides Hkv, else a
    replica per device (the reference's ``pool_shardings``)."""
    if not supports_paged(cfg):
        raise ValueError(f"{cfg.name}: paged pools require plain causal KV")
    shape = (cfg.num_periods, num_blocks, block_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)

    def leaf():
        if mesh is not None:
            return sharding.zeros(shape, dtype, mesh)
        return torch.zeros(shape, dtype=dtype, device=device)

    return {str(i): {"k": leaf(), "v": leaf()} for i, _ in enumerate(cfg.layer_pattern())}


def constrain_paged_pools(pools: Dict[str, PyTree], mesh) -> Dict[str, PyTree]:
    """Check that the pools are laid out over ``mesh`` as
    ``init_paged_pools`` lays them out (the reference pins the layout with
    sharding constraints at every paged entry point; the port updates the
    pools in place, so a layout cannot drift, only be handed in wrong).
    Raises ``ValueError`` on a mismatch; no-op without a mesh."""
    if mesh is None:
        return pools
    for pos, layer in pools.items():
        for kv, leaf in layer.items():
            ok = (isinstance(leaf, sharding.HeadSharded)
                  and leaf.sharded == sharding.shards_heads(leaf.heads, mesh)
                  and tuple(p.device for p in leaf.parts) == mesh.devices
                  and all(p.shape[-2] == hi - lo for p, (lo, hi) in
                          zip(leaf.parts, sharding.head_ranges(leaf.heads, mesh))))
            if not ok:
                raise ValueError(f"pool {pos}/{kv} is not laid out over the mesh's "
                                 f"{mesh.tp} shards")
    return pools


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
    periods.  Attention: ``{"k", "v"}`` (P, B, C, Hkv, D) and ``"pos"``
    (P, B, C), -1 for empty slots, with C = ``cache_capacity`` (a ring of
    the window's slots for a sliding window).  Mamba: ``"ssm"`` (P, B, nh,
    hd, dstate) fp32 and ``"conv"`` (P, B, W - 1, channels) in ``dtype``,
    zero.  Cross-attention: ``"ck"``, ``"cv"`` (P, B, num_image_tokens, Hkv,
    D), zero until a first chunk with image embeds writes them."""
    caches = {}
    cap = cache_capacity(cfg, max_seq)
    hd = cfg.resolved_head_dim
    for i, spec in enumerate(cfg.layer_pattern()):
        if spec.mixer == MIXER_MAMBA:
            st = mamba2.zero_state(cfg, batch, dtype, device)
            one = {"ssm": st.ssm, "conv": st.conv}
        elif spec.mixer == MIXER_CROSS_ATTN:
            shape = (batch, cfg.num_image_tokens, cfg.num_kv_heads, hd)
            one = {"ck": torch.zeros(shape, dtype=dtype, device=device),
                   "cv": torch.zeros(shape, dtype=dtype, device=device)}
        else:
            one = KVCache.init(batch, cap, cfg.num_kv_heads, hd, dtype, device)
        caches[str(i)] = {
            k: v[None].repeat((cfg.num_periods,) + (1,) * v.ndim) for k, v in one.items()
        }
    return caches


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed(cfg: ModelConfig, params: PyTree, inputs: torch.Tensor) -> torch.Tensor:
    """tokens (B, T) int -> (B, T, d); precomputed embeddings (B, T, d) pass
    through (``embed_inputs=False``)."""
    if cfg.embed_inputs:
        return params["embed"][inputs.long()]
    return inputs


def project_image_embeds(cfg: ModelConfig, params: PyTree,
                         image_embeds: torch.Tensor) -> torch.Tensor:
    """(B, P, vision_dim) stubbed-frontend patches -> (B, P, d), in the
    weights' dtype."""
    proj = params["vision_proj"]
    return image_embeds.to(proj.dtype) @ proj


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


def inject_sampled(
    tokens: torch.Tensor,  # (T,) flat ragged token batch (padded)
    idx: torch.Tensor,  # (R,) flat slots to overwrite
    sampled: torch.Tensor,  # (B,) last iteration's sampled tokens (padded)
    rows: torch.Tensor,  # (R,) row of each slot's value within `sampled`
) -> torch.Tensor:
    """Deferred-token injection of the pipelined engine (DESIGN.md §13):
    ``tokens[idx] = sampled[rows]`` as one device scatter, so a batch built
    before the previous iteration's tokens reached the host reads them on
    the device.  ``idx`` / ``rows`` pad by repeating a real pair (a full
    batch has no spare token slot to pad with); a repeated pair writes the
    same value twice."""
    return tokens.index_copy(0, idx.long(), sampled.index_select(0, rows.long()))


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
    mesh=None,  # tensor-parallel serving mesh (paged only)
    capacity_factor: float = 1.25,  # MoE layers; <= 0: dropless
    aux_out: Optional[List[torch.Tensor]] = None,  # MoE layers' aux losses, appended
    img_x: Optional[torch.Tensor] = None,  # (B, P, d) projected image embeds
) -> torch.Tensor:
    """Periods [lo, lo + num) of the stack; returns x.

    Paged (``block_tables`` given), ``mode`` picks each layer's attention:
    the fused ragged batch (with ``meta``), or the split path's prefill
    chunk or one-token decode.  Contiguous (``block_tables`` None):
    ``full`` runs the whole sequence with no prior context and, when
    ``caches`` is given, emits them (writes the roped K/V); ``prefill`` and
    ``decode`` attend through the caches (``cached_attention``).  A Mamba
    layer runs ``mamba_full`` from its carried state (zeros without caches)
    on ``full`` and ``prefill``, ``mamba_decode_step`` on ``decode``, and
    writes the new state into its caches in place.  A cross-attention layer
    projects its K/V from ``img_x`` when given (writing them into its caches
    in place, when there are caches), else reads them from its caches, and
    attends over them (``cross_attention``).  A MoE layer routes every
    row, padded ones too, with ``capacity_factor``."""
    paged = block_tables is not None
    if paged and not supports_paged(cfg):
        raise ValueError(f"{cfg.name}: the paged entry points need plain causal KV")
    if paged and ((mode == "ragged") != (meta is not None) or mode not in PAGED_MODES):
        raise ValueError(f"paged mode {mode!r} with meta={meta is not None}")
    if not paged and (meta is not None or mode not in CONTIGUOUS_MODES or mesh is not None
                      or (caches is None and mode != "full")):
        raise ValueError(f"contiguous mode {mode!r} with caches={caches is not None}")
    pattern = cfg.layer_pattern()
    for per in range(lo, lo + num):
        for i, spec in enumerate(pattern):
            lp = _period(layer_params[str(i)], per)
            cache = _period(caches[str(i)], per) if caches is not None else None
            h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
            if spec.mixer == MIXER_MAMBA:
                state = (None if cache is None
                         else mamba2.MambaState(ssm=cache["ssm"], conv=cache["conv"]))
                if mode == "decode":
                    mix, state = mamba2.mamba_decode_step(cfg, lp["mixer"], h, state)
                else:  # full or prefill: the chunked SSD from the carried state
                    mix, state = mamba2.mamba_full(cfg, lp["mixer"], h, state)
                if cache is not None:
                    cache["ssm"].copy_(state.ssm)
                    cache["conv"].copy_(state.conv)
            elif spec.mixer == MIXER_CROSS_ATTN:
                if img_x is not None:  # the first chunk or a full pass
                    ck, cv = project_cross_kv(cfg, lp["mixer"], img_x)
                    if cache is not None:
                        cache["ck"].copy_(ck)
                        cache["cv"].copy_(cv)
                elif cache is not None:
                    ck, cv = cache["ck"], cache["cv"]
                else:
                    raise ValueError(f"{cfg.name}: cross-attention needs image embeds "
                                     "or caches that hold their K/V")
                mix = cross_attention(cfg, lp["mixer"], h, ck, cv)
            elif paged and mode == "ragged":
                mix, _ = paged_ragged_attention(
                    cfg, lp["mixer"], h, cache, block_tables, positions, meta, mesh
                )
            elif paged:
                attn = paged_decode_attention if mode == "decode" else paged_prefill_attention
                mix, _ = attn(cfg, lp["mixer"], h, cache, block_tables, positions, mesh)
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
                h = rmsnorm(x, lp["norm2"], cfg.norm_eps)
                if spec.ffn == FFN_MOE:
                    h, aux = moe.moe_ffn(cfg, lp["ffn"], h, capacity_factor,
                                         aux=aux_out is not None)
                    if aux_out is not None:
                        aux_out.append(aux)
                else:
                    h = mlp(cfg, lp["ffn"], h)
                x = x + h
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
    mesh=None,  # tensor-parallel serving mesh (DESIGN.md §11)
) -> Tuple[torch.Tensor, Dict[str, PyTree]]:
    """Whole-stack fused mixed-batch forward. Returns ((S, V) logits, pools);
    the pools are the argument, updated in place."""
    x = embed(cfg, params, tokens[None])
    x = run_periods(cfg, params["layers"], 0, cfg.num_periods, x,
                    constrain_paged_pools(pools, mesh), block_tables, positions[None],
                    meta, mesh=mesh, capacity_factor=-1.0)
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
    mesh=None,  # tensor-parallel serving mesh (DESIGN.md §11)
) -> Tuple[torch.Tensor, Dict[str, PyTree]]:
    """One K-layer segment of the fused ragged batch.  Pool writes of an
    aborted iteration land at not-yet-committed positions and are rewritten
    verbatim on re-execution (§12 abort soundness; on a mesh every shard
    has run the same segments at an abort, §11)."""
    x = run_periods(cfg, params["layers"], lo, seg_periods, x,
                    constrain_paged_pools(pools, mesh), block_tables, positions, meta,
                    mesh=mesh, capacity_factor=-1.0)
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
    mesh=None,  # tensor-parallel serving mesh (DESIGN.md §11)
) -> Tuple[torch.Tensor, Dict[str, PyTree]]:
    """Chunked prefill on the paged layout.  Returns ((B, V) logits of each
    row's ``last_index`` token, or of its last token, and the pools, updated
    in place).  Padded positions write junk KV only into slots rewritten
    before they are read, into the scratch row, or past the table (dropped)."""
    x = embed(cfg, params, tokens)
    b, l = tokens.shape
    positions = offsets[:, None] + torch.arange(l, dtype=offsets.dtype,
                                                device=offsets.device)[None, :]
    x = run_periods(cfg, params["layers"], 0, cfg.num_periods, x,
                    constrain_paged_pools(pools, mesh), block_tables, positions,
                    mode="prefill", mesh=mesh, capacity_factor=-1.0)
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
    mesh=None,  # tensor-parallel serving mesh (DESIGN.md §11)
) -> Tuple[torch.Tensor, Dict[str, PyTree]]:
    """One decode iteration on the paged layout.  Returns ((B, V) logits,
    pools updated in place)."""
    x = embed(cfg, params, last_tokens[:, None])
    x = run_periods(cfg, params["layers"], 0, cfg.num_periods, x,
                    constrain_paged_pools(pools, mesh), block_tables, seq_lens[:, None],
                    mode="decode", mesh=mesh, capacity_factor=-1.0)
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
    mesh=None,  # tensor-parallel serving mesh (DESIGN.md §11)
) -> Tuple[torch.Tensor, Dict[str, PyTree]]:
    """One preemptible decode segment on the paged layout (paper §4.3
    safepoints).  Pool writes of an aborted iteration land at the
    not-yet-committed position and are rewritten verbatim on re-execution."""
    x = run_periods(cfg, params["layers"], lo, seg_periods, x,
                    constrain_paged_pools(pools, mesh), block_tables, positions,
                    mode="decode", mesh=mesh, capacity_factor=-1.0)
    return x, pools


def run_segment_paged(
    cfg: ModelConfig,
    params: PyTree,
    seg: int,
    x: torch.Tensor,
    pools: Dict[str, PyTree],
    block_tables: torch.Tensor,
    positions: torch.Tensor,
    mesh=None,  # tensor-parallel serving mesh (DESIGN.md §11)
) -> Tuple[torch.Tensor, Dict[str, PyTree]]:
    """``run_segment_paged_at`` addressed by segment index."""
    lo, hi = segment_bounds(cfg, seg)
    return run_segment_paged_at(cfg, params, hi - lo, lo, x, pools,
                                block_tables, positions, mesh=mesh)


# ---------------------------------------------------------------------------
# Contiguous entry points (per-request caches; RealEngineConfig(
# backend="contiguous")) and the whole-sequence forward
# ---------------------------------------------------------------------------


def forward_full(
    cfg: ModelConfig,
    params: PyTree,
    inputs: torch.Tensor,  # (B, T) tokens, or (B, T, d) embeddings (embed_inputs=False)
    *,
    image_embeds: Optional[torch.Tensor] = None,  # (B, P, vision_dim)
    emit_caches: bool = False,
    max_seq: Optional[int] = None,
    capacity_factor: float = 1.25,
    cache_dtype=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, PyTree]], torch.Tensor]:
    """Whole-sequence forward.  Returns ((B, T, V) fp32 logits, caches of
    capacity ``max_seq or T`` holding the sequence when ``emit_caches``,
    else None, and the auxiliary loss: the MoE layers' router losses summed,
    0 for a dense stack).  Every layer's attention is the flash attention
    over the whole sequence (the kernel on CUDA), causal or, for an encoder,
    not; a cross-attention layer attends over ``image_embeds``' K/V (a VLM
    without them needs ``emit_caches``: zero K/V, as in the reference)."""
    x = embed(cfg, params, inputs)
    b, t = x.shape[:2]
    positions = torch.arange(t, dtype=torch.int32, device=x.device).expand(b, t)
    img_x = None if image_embeds is None else project_image_embeds(cfg, params, image_embeds)
    caches = (
        init_caches(cfg, b, max_seq or t, cache_dtype or x.dtype, x.device)
        if emit_caches else None
    )
    auxes: List[torch.Tensor] = []
    x = run_periods(cfg, params["layers"], 0, cfg.num_periods, x, caches, None,
                    positions, mode="full", capacity_factor=capacity_factor,
                    aux_out=auxes, img_x=img_x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for a in auxes:
        aux = aux + a
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
    image_embeds: Optional[torch.Tensor] = None,  # (B, P, vision_dim), at offset 0
) -> Tuple[torch.Tensor, Dict[str, PyTree]]:
    """Chunked prefill on contiguous caches.  Returns ((B, V) logits of each
    row's last valid token, caches updated in place).  ``offsets`` are host
    integers (the reference takes a device array): the engine knows them,
    and the flash kernel's ``q_offset`` needs them without a read-back.
    Mamba layers refuse padded chunks (``lengths``), as in the reference:
    padding would run through the recurrent state, so the engine prefills
    SSM sequences unpadded, one per dispatch.  ``image_embeds``, given with
    a sequence's first chunk, write its cross-attention layers' K/V into
    the caches (the engine passes them at offset 0 only, as the
    reference's does)."""
    if lengths is not None and cfg.has_ssm_state:
        raise ValueError("ragged chunked prefill unsupported for SSM layers")
    x = embed(cfg, params, tokens)
    b, l = x.shape[:2]
    positions = _chunk_positions(offsets, l, x.device)
    img_x = None if image_embeds is None else project_image_embeds(cfg, params, image_embeds)
    valid = None
    if lengths is not None:
        valid = torch.arange(l, device=x.device)[None, :] < lengths[:, None]
    x = run_periods(cfg, params["layers"], 0, cfg.num_periods, x, caches, None,
                    positions, mode="prefill", valid=valid, q_offsets=offsets,
                    capacity_factor=-1.0, img_x=img_x)
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
    x = embed(cfg, params, last_tokens[:, None])
    x = run_periods(cfg, params["layers"], 0, cfg.num_periods, x, caches, None,
                    seq_lens[:, None], mode="decode", capacity_factor=-1.0)
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
    capacity_factor: float = 1.25,
) -> Tuple[torch.Tensor, Optional[Dict[str, PyTree]]]:
    """One preemptible segment (periods [lo, hi)) on contiguous caches.
    The caches are updated in place; the engine runs it on a stacked copy
    of its per-request caches, so an aborted decode leaves them untouched.
    MoE layers route at ``capacity_factor``, 1.25 as in the reference,
    whose engine calls it so on its segmented contiguous decode."""
    lo, hi = segment_bounds(cfg, seg)
    lp = slice_periods(params["layers"], lo, hi)
    cs = slice_periods(caches, lo, hi) if caches is not None else None
    x = run_periods(cfg, lp, 0, hi - lo, x, cs, None, positions, mode=mode,
                    valid=valid, q_offsets=q_offsets, capacity_factor=capacity_factor)
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
