"""Architecture registry — port of `repro.configs`: one module per
assigned architecture, the same data as the reference's.

`get_config(name)` returns the exact assigned configuration;
`get_config(name).reduced()` is the CPU smoke variant.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig

ARCH_IDS: List[str] = [
    "deepseek_moe_16b",
    "mamba2_370m",
    "granite_20b",
    "llama4_maverick_400b_a17b",
    "gemma3_4b",
    "whisper_small",
    "codeqwen15_7b",
    "qwen2_vl_72b",
    "stablelm_12b",
    "jamba_15_large_398b",
]

ALIASES = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mamba2-370m": "mamba2_370m",
    "granite-20b": "granite_20b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "gemma3-4b": "gemma3_4b",
    "whisper-small": "whisper_small",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "stablelm-12b": "stablelm_12b",
    "jamba-1.5-large-398b": "jamba_15_large_398b",
}


def get_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", ""))
    mod = importlib.import_module(f".{mod_name}", __package__)
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
