"""Model configurations: the paper's CNN (``yolo_baf``) and the LM zoo.

``get_config(arch_id)`` returns the full published config and
``get_smoke_config(arch_id)`` a reduced same-family config for CPU tests,
as ``repro.configs`` does. Every arch of the zoo is ported (``PORTED``:
the dense, moe, ssm, hybrid, vlm and audio families); an unknown id
raises ``KeyError``.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "rwkv6_3b", "qwen2_72b", "starcoder2_15b", "nemotron4_15b", "qwen2_7b",
    "whisper_tiny", "pixtral_12b", "olmoe_1b_7b", "arctic_480b", "zamba2_1p2b",
]
PORTED = tuple(ARCH_IDS)

_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
_ALIASES.update({
    "rwkv6-3b": "rwkv6_3b", "qwen2-72b": "qwen2_72b",
    "starcoder2-15b": "starcoder2_15b", "nemotron-4-15b": "nemotron4_15b",
    "qwen2-7b": "qwen2_7b", "whisper-tiny": "whisper_tiny",
    "pixtral-12b": "pixtral_12b", "olmoe-1b-7b": "olmoe_1b_7b",
    "arctic-480b": "arctic_480b", "zamba2-1.2b": "zamba2_1p2b",
})


def canonical(arch: str) -> str:
    return _ALIASES.get(arch, arch)


def _module(arch: str):
    name = canonical(arch)
    if name not in PORTED:
        raise KeyError(f"unknown arch {arch!r}; known: {', '.join(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str):
    return _module(arch).full_config()


def get_smoke_config(arch: str):
    return _module(arch).smoke_config()
