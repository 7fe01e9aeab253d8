"""Architecture registry: the 10 assigned architectures (port of
``repro.configs``).

``get_config(name)`` accepts the assignment id (e.g. "qwen1.5-4b").
"""
from __future__ import annotations

from .base import INPUT_SHAPES, ArchConfig, InputShape

from .qwen1_5_4b import CONFIG as _qwen
from .mamba2_370m import CONFIG as _mamba2
from .llava_next_34b import CONFIG as _llava
from .deepseek_v2_lite_16b import CONFIG as _dsv2
from .chatglm3_6b import CONFIG as _chatglm
from .seamless_m4t_medium import CONFIG as _seamless
from .arctic_480b import CONFIG as _arctic
from .yi_6b import CONFIG as _yi
from .hymba_1_5b import CONFIG as _hymba
from .command_r_35b import CONFIG as _commandr

ARCHS: dict[str, ArchConfig] = {c.name: c for c in [
    _qwen, _mamba2, _llava, _dsv2, _chatglm,
    _seamless, _arctic, _yi, _hymba, _commandr,
]}

__all__ = ["ARCHS", "INPUT_SHAPES", "ArchConfig", "InputShape", "get_config",
           "get_shape"]


def get_config(name: str) -> ArchConfig:
    key = name.replace("_", "-")
    if key in ARCHS:
        return ARCHS[key]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


def get_shape(name: str) -> InputShape:
    if name in INPUT_SHAPES:
        return INPUT_SHAPES[name]
    raise KeyError(f"unknown shape {name!r}; known: {sorted(INPUT_SHAPES)}")
