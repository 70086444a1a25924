"""Architecture registry, the counterpart of ``src/repro/configs``.

Each module defines ``FULL`` (the assigned production config, exact dims
from the pool spec) and ``SMOKE`` (a reduced same-family variant: ≤2 layers,
d_model ≤ 512, ≤4 experts) used by CPU tests. ``get(name)`` /
``get_smoke(name)`` look them up; ``--arch <id>`` in the launchers resolves
through here. The modules are copies of the JAX package's, as data; the
model (:mod:`repro_torch.models.model`) runs every id's family.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "granite_moe_3b_a800m",
    "gemma3_27b",
    "mamba2_2p7b",
    "deepseek_coder_33b",
    "phi3_vision_4p2b",
    "olmoe_1b_7b",
    "recurrentgemma_2b",
    "olmo_1b",
    "whisper_medium",
    "llama3_8b",
)

# public ids (dashes) → module names
ALIASES = {
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "gemma3-27b": "gemma3_27b",
    "mamba2-2.7b": "mamba2_2p7b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "olmo-1b": "olmo_1b",
    "whisper-medium": "whisper_medium",
    "llama3-8b": "llama3_8b",
}


def _module(name: str):
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "p"))
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get(name: str) -> ModelConfig:
    return _module(name).FULL


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


def all_archs() -> list[str]:
    return list(ALIASES.keys())
