"""Architecture registry: the configurations the PyTorch port serves.

``get_config(name)`` returns the full production config; ``--arch <id>`` in
the launchers resolves through this registry.  Each module cites its source.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

_MODULES = {
    "command-r-plus-104b": "command_r_plus_104b",
    "hubert-xlarge": "hubert_xlarge",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "mixtral-8x22b": "mixtral_8x22b",
    "qwen2-0.5b": "qwen2_0_5b",
    "yi-34b": "yi_34b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "gemma-7b": "gemma_7b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "mamba2-1.3b": "mamba2_1_3b",
    # the paper's own evaluation model
    "llama-2-7b": "llama2_7b",
}

def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {name: get_config(name) for name in _MODULES}
