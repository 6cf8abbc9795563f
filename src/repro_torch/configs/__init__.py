"""Assigned architecture registry: --arch <id> resolves here (the port's
copy of `repro.configs`)."""
from repro_torch.configs.base import ArchConfig, SHAPES


def _load(name: str) -> ArchConfig:
    import importlib
    mod = importlib.import_module(f"repro_torch.configs.{name.replace('-', '_')}")
    return mod.CONFIG


ARCH_IDS = [
    "gemma3-4b", "starcoder2-15b", "gemma3-27b", "stablelm-3b",
    "grok-1-314b", "qwen3-moe-30b-a3b", "hymba-1.5b", "hubert-xlarge",
    "mamba2-780m", "paligemma-3b",
]


def get_config(arch: str) -> ArchConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    return _load(arch.replace("-", "_").replace(".", "_"))


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


__all__ = ["ArchConfig", "SHAPES", "ARCH_IDS", "get_config", "all_configs"]
