"""Architecture registry: --arch <id> resolution for launchers/tests/benches.

A copy of ``repro.configs.registry`` (the Task Bench grid is not an arch:
its presets are in ``configs/taskbench.py``). Every arch is listed, and
``models.model.Model`` builds and ``launch.serve`` serves each of them.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.configs import (
    gemma3_4b,
    granite_moe_3b_a800m,
    hymba_1_5b,
    internlm2_1_8b,
    llama_3_2_vision_90b,
    mamba2_130m,
    minitron_8b,
    mixtral_8x7b,
    musicgen_medium,
    stablelm_3b,
)
from repro_torch.configs.base import SHAPE_BY_NAME, SHAPES, ModelConfig, ShapeConfig

_MODULES = (
    hymba_1_5b,
    mixtral_8x7b,
    granite_moe_3b_a800m,
    musicgen_medium,
    gemma3_4b,
    internlm2_1_8b,
    minitron_8b,
    stablelm_3b,
    llama_3_2_vision_90b,
    mamba2_130m,
)

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}") from None


def list_archs() -> List[str]:
    return list(ARCHS)


def get_shape(name: str) -> ShapeConfig:
    try:
        return SHAPE_BY_NAME[name]
    except KeyError:
        raise KeyError(
            f"unknown shape {name!r}; known: {sorted(SHAPE_BY_NAME)}"
        ) from None


def cells(include_skips: bool = True) -> List[Tuple[ModelConfig, ShapeConfig, bool]]:
    """All (arch x shape) cells; the bool marks runnable (False = documented
    long-context skip for pure full-attention archs, DESIGN.md §6)."""
    out = []
    for cfg in ARCHS.values():
        for shape in SHAPES:
            runnable = shape.name != "long_500k" or cfg.supports_long_context
            if runnable or include_skips:
                out.append((cfg, shape, runnable))
    return out
