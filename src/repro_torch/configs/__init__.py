"""Assigned-architecture registry: ``get_config(arch_id)``."""
from .base import (LONG_500K, DECODE_32K, PREFILL_32K, TRAIN_4K, ModelConfig,
                   SHAPES, ShapeConfig, applicable, shape_by_name)

_REGISTRY = {}


def register(fn):
    cfg = fn()
    _REGISTRY[cfg.name] = cfg
    return fn


def get_config(name: str) -> ModelConfig:
    from . import (zamba2_1p2b, whisper_small, h2o_danube3_4b, llama3p2_3b,
                   smollm_360m, qwen2_7b, mamba2_1p3b, arctic_480b,
                   deepseek_v2_236b, llava_next_mistral_7b)  # noqa: F401
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    return _REGISTRY[name]


def all_arch_names():
    get_config("smollm-360m")  # force registration
    return sorted(_REGISTRY)
