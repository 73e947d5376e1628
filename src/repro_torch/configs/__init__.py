"""Architecture registry (port of `repro.configs`).

Each config module exposes FULL (the exact published config) and SMOKE
(reduced for tests).  The port carries stablelm-1.6b so far; the other
nine architectures of the JAX package come in later slices and raise
until then.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = ["stablelm_1p6b"]

# CLI aliases (the assignment's spelling) -> module names
ALIASES = {
    "mamba2-1.3b": "mamba2_1p3b",
    "minitron-4b": "minitron_4b",
    "yi-34b": "yi_34b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "zamba2-1.2b": "zamba2_1p2b",
    "stablelm-1.6b": "stablelm_1p6b",
    "internvl2-2b": "internvl2_2b",
    "musicgen-large": "musicgen_large",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "qwen3-14b": "qwen3_14b",
}


def canonical(name: str) -> str:
    return ALIASES.get(name, name.replace("-", "_").replace(".", "p"))


def get_config(name: str, variant: str = "full") -> ModelConfig:
    mod_name = canonical(name)
    if mod_name not in ARCH_IDS:
        known = mod_name in ALIASES.values()
        raise ValueError(
            f"architecture {name!r} "
            + ("not yet ported to repro_torch" if known else "is unknown")
            + f"; ported: {ARCH_IDS}"
        )
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    if variant not in ("full", "smoke"):
        raise ValueError(f"unknown variant {variant!r}; pick 'full' or 'smoke'")
    return mod.FULL if variant == "full" else mod.SMOKE

