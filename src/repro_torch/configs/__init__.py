"""Architecture registry: one module per assigned architecture (a copy of
``repro.configs``).

``get_config(arch_id)`` returns the full-size ModelConfig;
``get_smoke_config(arch_id)`` the reduced same-family config for CPU tests.
"""
from __future__ import annotations

import importlib

ARCHS = (
    "starcoder2_15b",
    "internlm2_1_8b",
    "phi3_mini_3_8b",
    "command_r_35b",
    "llava_next_34b",
    "falcon_mamba_7b",
    "qwen3_moe_235b_a22b",
    "dbrx_132b",
    "musicgen_large",
    "hymba_1_5b",
)

# CLI ids (--arch) with dashes/dots, mapped to module names
ARCH_IDS = {
    "starcoder2-15b": "starcoder2_15b",
    "internlm2-1.8b": "internlm2_1_8b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "command-r-35b": "command_r_35b",
    "llava-next-34b": "llava_next_34b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "dbrx-132b": "dbrx_132b",
    "musicgen-large": "musicgen_large",
    "hymba-1.5b": "hymba_1_5b",
}


def _module(arch: str):
    mod = ARCH_IDS.get(arch, arch).replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    m = _module(arch)
    return getattr(m, "SMOKE", m.CONFIG.scaled_down())


def all_arch_ids() -> list[str]:
    return list(ARCH_IDS)
