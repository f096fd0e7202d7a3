"""Mamba-2 1.3B — pure SSM, SSD (state-space duality) [arXiv:2405.21060].

Attention-free: no FFN sublayer (d_ff=0), mixer-only blocks as in the
Mamba-2 paper.  O(1)-state decode => runs long_500k natively.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    source="arXiv:2405.21060",
    num_layers=48,
    d_model=2048,
    num_heads=1,      # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state_size=128,
    ssm_head_dim=64,
    tie_embeddings=True,
)
