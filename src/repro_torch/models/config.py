"""Unified model configuration covering every assigned architecture family.

One dataclass describes dense / MoE / SSM / hybrid / VLM / audio-encoder
backbones.  The layer stack is described by a repeating *pattern* of
``LayerSpec``s (mixer kind + FFN kind) of length ``pattern_period``; uniform
architectures have period 1, Jamba has period 8 (7 mamba + 1 attention),
Llama-3.2-Vision has period 5 (4 self-attention + 1 cross-attention).
``num_layers`` must be a multiple of the period so the stack can be executed
as ``lax.scan`` over periods (compact HLO — required for the 40-combo
multi-pod dry-run to compile in reasonable time).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# ---------------------------------------------------------------------------
# Layer pattern
# ---------------------------------------------------------------------------

MIXER_ATTN = "attn"
MIXER_MAMBA = "mamba"
MIXER_CROSS_ATTN = "cross_attn"

FFN_DENSE = "dense"
FFN_MOE = "moe"


@dataclass(frozen=True)
class LayerSpec:
    """One position inside the repeating layer pattern."""

    mixer: str  # attn | mamba | cross_attn
    ffn: str  # dense | moe


@dataclass(frozen=True)
class ModelConfig:
    # -- identity ----------------------------------------------------------
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""  # citation (paper / model card)

    # -- core dims ---------------------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0  # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024

    # -- attention flavour ---------------------------------------------------
    qkv_bias: bool = False
    o_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0  # 0 = full attention
    causal: bool = True  # False for encoder-only (audio)

    # -- FFN flavour ---------------------------------------------------------
    activation: str = "swiglu"  # swiglu | geglu | gelu
    mlp_bias: bool = False

    # -- MoE -----------------------------------------------------------------
    num_experts: int = 0  # 0 = dense FFN everywhere
    experts_per_token: int = 0
    moe_every: int = 1  # MoE FFN on layers where idx % moe_every == moe_offset
    moe_offset: int = 0
    router_aux_coef: float = 0.01

    # -- SSM (Mamba-2 / SSD) --------------------------------------------------
    ssm_state_size: int = 0  # 0 = no mamba layers anywhere
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256  # SSD chunk length
    attn_period: int = 0  # hybrid: every `attn_period`-th layer is attention

    # -- VLM -----------------------------------------------------------------
    cross_attn_period: int = 0  # every k-th layer is cross-attention
    vision_dim: int = 0  # stubbed frontend embedding width
    num_image_tokens: int = 0

    # -- embeddings / norm -----------------------------------------------------
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    embed_inputs: bool = True  # False -> inputs are precomputed embeddings (audio)
    logit_softcap: float = 0.0

    # -- serving / preemption ---------------------------------------------------
    safepoint_interval: int = 8  # layers per preemptible segment (paper §4.3)

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def q_groups(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    # ------------------------------------------------------------------
    def layer_pattern(self) -> List[LayerSpec]:
        """The repeating pattern of layer kinds (length = pattern period)."""
        if self.attn_period:  # hybrid (Jamba): 1 attn every `attn_period`
            period = self.attn_period
            specs = []
            for i in range(period):
                mixer = MIXER_ATTN if i == period - 1 else MIXER_MAMBA
                specs.append(LayerSpec(mixer, self._ffn_kind(i)))
            return specs
        if self.cross_attn_period:  # VLM: 1 cross-attn every k layers
            period = self.cross_attn_period
            return [
                LayerSpec(
                    MIXER_CROSS_ATTN if i == period - 1 else MIXER_ATTN,
                    self._ffn_kind(i),
                )
                for i in range(period)
            ]
        if self.ssm_state_size and not self.attn_period:  # pure SSM
            return [LayerSpec(MIXER_MAMBA, self._ffn_kind(0))]
        period = self.moe_every if self.num_experts else 1
        return [LayerSpec(MIXER_ATTN, self._ffn_kind(i)) for i in range(period)]

    def _ffn_kind(self, idx_in_period: int) -> str:
        if not self.num_experts:
            return FFN_DENSE
        return FFN_MOE if idx_in_period % self.moe_every == self.moe_offset else FFN_DENSE

    @property
    def pattern_period(self) -> int:
        return len(self.layer_pattern())

    @property
    def num_periods(self) -> int:
        period = self.pattern_period
        if self.num_layers % period:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"pattern period {period}"
            )
        return self.num_layers // period

    # ------------------------------------------------------------------
    @property
    def has_kv_cache(self) -> bool:
        """True if any layer carries a KV cache (attention or cross-attn)."""
        return self.causal and any(
            s.mixer in (MIXER_ATTN, MIXER_CROSS_ATTN) for s in self.layer_pattern()
        )

    @property
    def has_ssm_state(self) -> bool:
        return any(s.mixer == MIXER_MAMBA for s in self.layer_pattern())

    @property
    def supports_decode(self) -> bool:
        return self.causal  # encoder-only archs never decode

    @property
    def subquadratic(self) -> bool:
        """Can run 500k-token decode: SSM or hybrid (attention is the 1-in-k
        minority and its KV cache shards over the mesh), or sliding-window
        attention.  Pure full-attention and cross-attention archs cannot."""
        if self.has_ssm_state:
            return True  # SSM/hybrid (assignment: run long_500k for these)
        specs = self.layer_pattern()
        for s in specs:
            if s.mixer == MIXER_ATTN and not self.sliding_window:
                return False
            if s.mixer == MIXER_CROSS_ATTN:
                return False
        return True

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        hd = self.resolved_head_dim
        n = 0
        if self.embed_inputs:
            n += self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        if self.vision_dim:
            n += self.vision_dim * self.d_model
        for spec in self.layer_pattern():
            per = 0
            if spec.mixer in (MIXER_ATTN, MIXER_CROSS_ATTN):
                q = self.d_model * self.num_heads * hd
                kv = 2 * self.d_model * self.num_kv_heads * hd
                o = self.num_heads * hd * self.d_model
                per += q + kv + o
                if self.qkv_bias:
                    per += (self.num_heads + 2 * self.num_kv_heads) * hd
            else:  # mamba
                d_in = self.d_inner
                nh = self.ssm_num_heads
                g = 1  # single B/C group
                proj_out = 2 * d_in + 2 * g * self.ssm_state_size + nh
                per += self.d_model * proj_out  # in_proj
                per += self.ssm_conv_width * (d_in + 2 * g * self.ssm_state_size)
                per += nh * 2  # A_log, dt_bias
                per += d_in  # D skip
                per += d_in * self.d_model  # out_proj
            if spec.ffn == FFN_MOE:
                per += self.d_model * self.num_experts  # router
                per += self.num_experts * 3 * self.d_model * self.d_ff
            elif self.d_ff:
                gates = 3 if self.activation in ("swiglu", "geglu") else 2
                per += gates * self.d_model * self.d_ff
            per += 2 * self.d_model  # two norms
            n += per * self.num_periods
        n += self.d_model  # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if not self.num_experts:
            return self.param_count()
        full = self.param_count()
        moe_layers = sum(
            1 for s in self.layer_pattern() if s.ffn == FFN_MOE
        ) * self.num_periods
        all_experts = moe_layers * self.num_experts * 3 * self.d_model * self.d_ff
        active = moe_layers * self.experts_per_token * 3 * self.d_model * self.d_ff
        return full - all_experts + active

    # ------------------------------------------------------------------
    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test variant of the same family (CPU-runnable)."""
        period = self.pattern_period
        d_model = min(self.d_model, 256)
        num_heads = min(self.num_heads, 4)
        num_kv = max(1, min(self.num_kv_heads, num_heads))
        while num_heads % num_kv:
            num_kv -= 1
        small = dict(
            name=self.name + "-smoke",
            num_layers=2 * period if period > 1 else 2,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=min(self.resolved_head_dim, 64) if self.head_dim else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2)
            if self.experts_per_token
            else 0,
            ssm_state_size=min(self.ssm_state_size, 16) if self.ssm_state_size else 0,
            ssm_head_dim=16 if self.ssm_state_size else self.ssm_head_dim,
            ssm_chunk=32 if self.ssm_state_size else self.ssm_chunk,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            vision_dim=min(self.vision_dim, 128) if self.vision_dim else 0,
            num_image_tokens=min(self.num_image_tokens, 16)
            if self.num_image_tokens
            else 0,
            safepoint_interval=max(1, period),
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Whether an (arch, shape) combo is runnable, and why not if skipped."""
    if shape.kind == "decode":
        if not cfg.supports_decode:
            return False, "encoder-only architecture has no decode step"
        if shape.seq_len >= 500_000 and not cfg.subquadratic:
            return (
                False,
                "full quadratic attention; long_500k requires sub-quadratic "
                "(SSM/hybrid/sliding-window)",
            )
    return True, ""
