"""Assigned architecture configs (exact published shapes) + smoke twins."""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from ..models.config import ModelConfig

ARCH_IDS = (
    "recurrentgemma_9b",
    "mixtral_8x22b",
    "llama4_maverick_400b_a17b",
    "rwkv6_1p6b",
    "gemma2_9b",
    "chatglm3_6b",
    "codeqwen1p5_7b",
    "deepseek_coder_33b",
    "whisper_large_v3",
    "llama3p2_vision_11b",
)

# CLI aliases matching the assignment spelling
ALIASES = {
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mixtral-8x22b": "mixtral_8x22b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "gemma2-9b": "gemma2_9b",
    "chatglm3-6b": "chatglm3_6b",
    "codeqwen1.5-7b": "codeqwen1p5_7b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "whisper-large-v3": "whisper_large_v3",
    "llama-3.2-vision-11b": "llama3p2_vision_11b",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    arch = ALIASES.get(arch, arch).replace("-", "_").replace(".", "p")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.SMOKE if smoke else mod.CONFIG


def all_configs(smoke: bool = False) -> Dict[str, ModelConfig]:
    return {a: get_config(a, smoke) for a in ARCH_IDS}
