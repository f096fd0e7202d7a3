"""Yi-34B — llama-architecture dense GQA [arXiv:2403.04652]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    arch_type="dense",
    source="arXiv:2403.04652",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    activation="swiglu",
    rope_theta=5000000.0,
)
