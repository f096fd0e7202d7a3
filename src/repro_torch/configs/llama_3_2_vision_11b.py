"""Llama-3.2-Vision 11B — text decoder w/ cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision].

The ViT vision encoder + projector are STUBBED per the assignment:
``input_specs()`` supplies precomputed patch embeddings (vision_dim wide);
every 5th decoder layer is a cross-attention layer over them (8 of 40).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    arch_type="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    activation="swiglu",
    rope_theta=500000.0,
    cross_attn_period=5,
    vision_dim=1280,
    num_image_tokens=576,
)
