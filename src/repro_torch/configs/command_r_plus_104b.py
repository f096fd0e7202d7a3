"""Command R+ 104B — dense GQA, no biases [hf:CohereForAI/c4ai-command-r-v01]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    arch_type="dense",
    source="hf:CohereForAI/c4ai-command-r-v01",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    activation="swiglu",
    rope_theta=75_000_000.0,
)
