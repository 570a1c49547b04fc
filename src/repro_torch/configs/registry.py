"""Architecture registry: ``--arch <id>`` -> ModelConfig (full or smoke).

The port carries every architecture of the JAX registry that fits one
card; the two that do not (jamba-v0.1-52b, arctic-480b) raise
``NotImplementedError`` saying so."""
from __future__ import annotations

from typing import Dict, List

from . import (deepseek_v2_lite_16b, falcon_mamba_7b, gemma_7b,
               qwen1_5_32b, qwen2_5_3b, qwen2_vl_2b, qwen3_4b,
               seamless_m4t_large_v2)
from .base import ModelConfig

_MODULES = {"qwen2-vl-2b": qwen2_vl_2b,
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

# the JAX registry's other architectures, not registered yet: at full
# width each fits one card only at reduced depth (JAX's trainer takes any
# --n-layers; ROADMAP queue A 13)
UNPORTED = {
    "jamba-v0.1-52b": "registering: at full width about 12.8 B parameters "
                      "an 8-layer group, so two of its four groups fit one "
                      "card (its Mamba, attention and MoE layers are "
                      "ported; ROADMAP queue A 13(c))",
    "arctic-480b": "registering: at full width about 13.7 B parameters a "
                   "layer, so 2 of its 35 layers fit one card (its MoE "
                   "layers are ported; ROADMAP queue A 13(b))",
}


def list_archs() -> List[str]:
    return list(ARCHS)


def _check(name: str) -> None:
    if name in UNPORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: it needs {UNPORTED[name]}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {list(ARCHS)}")


def get_arch(name: str) -> ModelConfig:
    _check(name)
    return ARCHS[name]


def get_smoke_arch(name: str) -> ModelConfig:
    _check(name)
    return SMOKE_ARCHS[name]
