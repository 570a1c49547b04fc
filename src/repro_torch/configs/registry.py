"""Architecture registry: ``--arch <id>`` -> ModelConfig (full or smoke).

The port carries every architecture of the JAX registry, at its
published depth.  Two of them (jamba-v0.1-52b, arctic-480b) hold more
weights than one card: ``launch.serve`` refuses that depth before it
draws a weight and names the largest that fits, and an in-process caller
serves them at a reduced depth (``serve.main(..., cfg=...)``)."""
from __future__ import annotations

from typing import Dict, List

from . import (arctic_480b, deepseek_v2_lite_16b, falcon_mamba_7b,
               gemma_7b, jamba_v0_1_52b, qwen1_5_32b, qwen2_5_3b,
               qwen2_vl_2b, qwen3_4b, seamless_m4t_large_v2)
from .base import ModelConfig

_MODULES = {"qwen2-vl-2b": qwen2_vl_2b,
            "jamba-v0.1-52b": jamba_v0_1_52b,
            "arctic-480b": arctic_480b,
            "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
            "qwen2.5-3b": qwen2_5_3b,
            "qwen1.5-32b": qwen1_5_32b,
            "qwen3-4b": qwen3_4b,
            "gemma-7b": gemma_7b,
            "seamless-m4t-large-v2": seamless_m4t_large_v2,
            "falcon-mamba-7b": falcon_mamba_7b}
ARCHS: Dict[str, ModelConfig] = {k: m.CONFIG for k, m in _MODULES.items()}
SMOKE_ARCHS: Dict[str, ModelConfig] = {k: m.SMOKE
                                       for k, m in _MODULES.items()}


def list_archs() -> List[str]:
    return list(ARCHS)


def _check(name: str) -> None:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {list(ARCHS)}")


def get_arch(name: str) -> ModelConfig:
    _check(name)
    return ARCHS[name]


def get_smoke_arch(name: str) -> ModelConfig:
    _check(name)
    return SMOKE_ARCHS[name]
