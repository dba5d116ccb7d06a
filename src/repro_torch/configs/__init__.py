"""Architectures the port supports so far (slice 1: the paper's proxy)."""
from __future__ import annotations

from repro_torch.configs import paper_resnet_proxy
from repro_torch.models.config import ModelConfig

ARCHS = {paper_resnet_proxy.CONFIG.name: paper_resnet_proxy.CONFIG}


def get_config(arch: str) -> ModelConfig:
    try:
        return ARCHS[arch]
    except KeyError:
        raise ValueError(
            f"unknown arch {arch!r}; the port supports {sorted(ARCHS)}"
        ) from None
