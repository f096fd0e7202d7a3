"""Mixtral 8x22B — MoE 8 experts top-2, sliding-window attention
[arXiv:2401.04088].

SWA (window 4096) makes decode memory O(window) — this arch therefore RUNS
the long_500k shape with a ring-buffer KV cache (DESIGN.md §4).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    arch_type="moe",
    source="arXiv:2401.04088",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    activation="swiglu",
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    rope_theta=1000000.0,
)
