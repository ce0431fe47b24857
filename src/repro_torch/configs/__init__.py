"""Architecture registry (same names and aliases as ``repro.configs``).

Only the architectures this port runs have a module here; asking for any
other known architecture raises ``NotImplementedError`` naming the roadmap.
"""
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

#: architectures with a config module (and a model path) in the port
PORTED = ("qwen3_1_7b",)

_ALIASES = {name.replace("_", "-"): name for name in ARCHS}
_ALIASES.update({
    "internvl2-2b": "internvl2_2b",
    "mamba2-1.3b": "mamba2_1_3b",
    "qwen3-1.7b": "qwen3_1_7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "whisper-small": "whisper_small",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "command-r-35b": "command_r_35b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "qwen3-4b": "qwen3_4b",
    "granite-20b": "granite_20b",
})


def get_config(name: str):
    key = _ALIASES.get(name, name)
    if key not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; choose from {sorted(_ALIASES)}")
    if key not in PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not yet ported to repro_torch; see ROADMAP.md "
            f"(ported: {', '.join(PORTED)})"
        )
    return importlib.import_module(f"repro_torch.configs.{key}").CONFIG


def list_archs() -> tuple[str, ...]:
    return tuple(n.replace("_", "-") for n in ARCHS)
