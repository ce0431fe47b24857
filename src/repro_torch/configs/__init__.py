"""Architecture registry (same names and aliases as ``repro.configs``):
every architecture of the reference has a config module here."""
from __future__ import annotations

import importlib

ARCHS = (
    "internvl2_2b",
    "mamba2_1_3b",
    "qwen3_1_7b",
    "deepseek_moe_16b",
    "whisper_small",
    "llama4_scout_17b_a16e",
    "command_r_35b",
    "recurrentgemma_2b",
    "qwen3_4b",
    "granite_20b",
)

#: the name each architecture goes by (``--arch``)
NAMES = {
    "internvl2_2b": "internvl2-2b",
    "mamba2_1_3b": "mamba2-1.3b",
    "qwen3_1_7b": "qwen3-1.7b",
    "deepseek_moe_16b": "deepseek-moe-16b",
    "whisper_small": "whisper-small",
    "llama4_scout_17b_a16e": "llama4-scout-17b-a16e",
    "command_r_35b": "command-r-35b",
    "recurrentgemma_2b": "recurrentgemma-2b",
    "qwen3_4b": "qwen3-4b",
    "granite_20b": "granite-20b",
}

_ALIASES = {name.replace("_", "-"): name for name in ARCHS}
_ALIASES.update({name: key for key, name in NAMES.items()})


def get_config(name: str):
    key = _ALIASES.get(name, name)
    if key not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; choose from {sorted(_ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{key}").CONFIG


def list_archs() -> tuple[str, ...]:
    return tuple(NAMES[n] for n in ARCHS)

