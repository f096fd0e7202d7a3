"""Gemma 7B — dense, GeGLU, head_dim=256 [arXiv:2403.08295].

(The 2B sibling uses MQA; the assigned 7B uses 16 KV heads = MHA.)
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    arch_type="dense",
    source="arXiv:2403.08295",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    activation="geglu",
    tie_embeddings=True,
)
