"""Architecture registry: --arch <id> resolves here. `ARCH_IDS` is the
port's copy of `repro.configs`' assigned list; `PORT_ARCH_IDS` are the
architectures only the port runs."""
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

# layers of different kinds (`ArchConfig.mixer_pattern`)
PORT_ARCH_IDS = ["granite-4.0-h-micro"]


def get_config(arch: str) -> ArchConfig:
    if arch not in ARCH_IDS + PORT_ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; choose from "
                       f"{ARCH_IDS + PORT_ARCH_IDS}")
    return _load(arch.replace("-", "_").replace(".", "_"))


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


__all__ = ["ArchConfig", "SHAPES", "ARCH_IDS", "PORT_ARCH_IDS", "get_config",
           "all_configs"]
