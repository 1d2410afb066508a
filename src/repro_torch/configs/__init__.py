"""Registry of the assigned architectures (``--arch <id>``)."""

from __future__ import annotations

from typing import Dict

from repro_torch.models.config import ModelConfig

from repro_torch.configs import (  # noqa: E402
    deepseek_7b,
    deepseek_v2_236b,
    grok_1_314b,
    jamba_1_5_large_398b,
    qwen1_5_110b,
    qwen2_5_14b,
    qwen2_vl_2b,
    rwkv6_7b,
    smollm_135m,
    whisper_medium,
)

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        deepseek_v2_236b,
        rwkv6_7b,
        jamba_1_5_large_398b,
        qwen2_5_14b,
        whisper_medium,
        qwen2_vl_2b,
        grok_1_314b,
        smollm_135m,
        qwen1_5_110b,
        deepseek_7b,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
