"""Jamba 1.5 Large 398B — hybrid Mamba+attention 1:7, MoE 16e top-2
[arXiv:2403.19887].

Layer pattern: period of 8 (7 Mamba mixers + 1 attention mixer), MoE FFN on
every other layer (moe_every=2) as in the Jamba paper — this keeps total
params ~398B.  Sub-quadratic overall => runs long_500k.  Mamba mixers use
our Mamba-2/SSD layer (state 128); the original uses
Mamba-1 — the serving-layer technique (state checkpointing) is identical.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    source="arXiv:2403.19887",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    activation="swiglu",
    num_experts=16,
    experts_per_token=2,
    moe_every=2,
    moe_offset=1,
    attn_period=8,
    ssm_state_size=128,
    ssm_head_dim=64,
)
