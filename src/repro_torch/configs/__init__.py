"""Architecture configs (--arch <id>): the port's copy of repro.configs.

``base.py`` and the config files of the dense, MoE, VLM, SSM and hybrid
families are the reference's, verbatim (data only).  The enc-dec config
comes with its model (ROADMAP A14); ``get_config`` names that item for
it.
"""
from . import base
from .base import ArchConfig, SHAPES, ShapeSpec, reduced_for_smoke

ARCH_IDS = [
    "paligemma-3b", "llama3.2-3b", "granite-8b", "qwen2-72b", "qwen2-0.5b",
    "arctic-480b", "qwen3-moe-30b-a3b", "mamba2-1.3b", "zamba2-7b",
    "whisper-medium",
]

#: The configs this port carries, served by ``models.zoo.build``: the dense
#: family, the MoE family, the VLM, the SSM and the hybrid.
PORTED_IDS = ("llama3.2-3b", "granite-8b", "qwen2-72b", "qwen2-0.5b",
              "qwen3-moe-30b-a3b", "arctic-480b", "paligemma-3b",
              "mamba2-1.3b", "zamba2-7b")


def get_config(arch_id: str) -> ArchConfig:
    import importlib
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    if arch_id not in PORTED_IDS:
        raise NotImplementedError(
            f"{arch_id}: the port carries {', '.join(PORTED_IDS)}; the "
            "enc-dec family comes with ROADMAP A14")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG


__all__ = ["base", "ArchConfig", "SHAPES", "ShapeSpec", "reduced_for_smoke",
           "ARCH_IDS", "PORTED_IDS", "get_config"]
