"""HuBERT X-Large — audio encoder-only backbone [arXiv:2106.07447].

The conv/mel frontend is STUBBED per the assignment: inputs are precomputed
frame embeddings of width d_model; the model is the transformer encoder +
the masked-unit classification head (504 k-means units).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    arch_type="audio",
    source="arXiv:2106.07447",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    activation="gelu",
    mlp_bias=True,
    qkv_bias=True,
    causal=False,        # bidirectional encoder
    embed_inputs=False,  # frame embeddings come from the (stubbed) frontend
)
