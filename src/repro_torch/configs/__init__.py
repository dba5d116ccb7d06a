"""Architecture configs the port trains, with the JAX package's values
and sources (counterpart of ``repro.configs``), and the input shapes.

Select with ``--arch <id>``: ``ARCHS[id]()`` returns the full
``ModelConfig``, ``ARCHS[id]().smoke_variant()`` the reduced CPU-test
variant. ``ARCHS`` holds the JAX package's configs in its order.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, Tuple

from repro_torch.models.config import ModelConfig

_ARCH_MODULES = [
    "whisper_tiny",
    "qwen2_5_3b",
    "internvl2_1b",
    "mamba2_780m",
    "chatglm3_6b",
    "zamba2_7b",
    "mixtral_8x7b",
    "deepseek_moe_16b",
    "granite_3_8b",
    "phi3_medium_14b",
    "granite_3_8b_swa",  # SWA variant of granite-3-8b (long_500k)
    "paper_resnet_proxy",  # the paper's own NN experiment proxy
]

ARCHS: Dict[str, Callable[[], ModelConfig]] = {}
for _m in _ARCH_MODULES:
    _mod = importlib.import_module(f"repro_torch.configs.{_m}")
    ARCHS[_mod.CONFIG.name] = (lambda c: (lambda: c))(_mod.CONFIG)


def get_config(arch: str) -> ModelConfig:
    try:
        return ARCHS[arch]()
    except KeyError:
        raise ValueError(
            f"unknown arch {arch!r}; available: {sorted(ARCHS)}"
        ) from None


# --- input shapes: (seq_len, global_batch, kind) ---------------------------
INPUT_SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}

# archs able to run long_500k (sub-quadratic or bounded-memory decode)
LONG_CONTEXT_OK = {
    "mamba2-780m",
    "zamba2-7b",
    "mixtral-8x7b",
    "granite-3-8b-swa",
}


def shape_applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_CONTEXT_OK
    return True
