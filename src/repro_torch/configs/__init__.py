"""Architecture configs (--arch <id>): the port's copy of repro.configs.

``base.py`` and the config files of every family (dense, MoE, VLM, SSM,
hybrid, enc-dec) are the reference's, verbatim (data only).
"""
from . import base
from .base import ArchConfig, SHAPES, ShapeSpec, reduced_for_smoke

ARCH_IDS = [
    "paligemma-3b", "llama3.2-3b", "granite-8b", "qwen2-72b", "qwen2-0.5b",
    "arctic-480b", "qwen3-moe-30b-a3b", "mamba2-1.3b", "zamba2-7b",
    "whisper-medium",
]

#: The configs this port carries, served by ``models.zoo.build``: the dense
#: family, the MoE family, the VLM, the SSM, the hybrid and the enc-dec.
PORTED_IDS = ("llama3.2-3b", "granite-8b", "qwen2-72b", "qwen2-0.5b",
              "qwen3-moe-30b-a3b", "arctic-480b", "paligemma-3b",
              "mamba2-1.3b", "zamba2-7b", "whisper-medium")


def get_config(arch_id: str) -> ArchConfig:
    import importlib
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG


__all__ = ["base", "ArchConfig", "SHAPES", "ShapeSpec", "reduced_for_smoke",
           "ARCH_IDS", "PORTED_IDS", "get_config"]
