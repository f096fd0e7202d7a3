"""Llama-2-7B — the paper's own evaluation model [arXiv:2307.09288]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-2-7b",
    arch_type="dense",
    source="arXiv:2307.09288 (ConServe §6 evaluation model)",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=32000,
    activation="swiglu",
)
