"""Architecture registry of the port.

``get(arch_id)`` returns the full production config; ``get_reduced`` returns
the same family at smoke-test scale; ``get_bundle`` wraps either in the
unified ModelBundle API.  The port carries all eleven architectures of the
reference: the paper's Llama3-8B and eight more transformers (MoE, MLA,
sandwich norms, the parallel block, a modality prefix; kernels K1 and K3),
mamba2-1.3b (Mamba-2, kernel K4) and recurrentgemma-9b (Griffin, kernels K5
and K1).
"""

from __future__ import annotations

from importlib import import_module
from typing import Any

_MODULES = {
    "stablelm-3b": "stablelm_3b",
    "command-r-plus-104b": "command_r_plus_104b",
    "gemma2-9b": "gemma2_9b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "internvl2-1b": "internvl2_1b",
    "mamba2-1.3b": "mamba2_1_3b",
    "musicgen-medium": "musicgen_medium",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "llama3-8b": "llama3_8b",
}

# the dry-run's sweep: every config but the paper's Llama (the reference's)
ASSIGNED_ARCHS = tuple(k for k in _MODULES if k != "llama3-8b")
ALL_ARCHS = tuple(_MODULES)
# sub-quadratic sequence mixers: the only families the dry-run's long_500k
# decode cell runs (attention over 524k keys is skipped, as the reference's)
LONG_CONTEXT_ARCHS = ("mamba2-1.3b", "recurrentgemma-9b")


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get(arch: str) -> Any:
    return _module(arch).config()


def get_reduced(arch: str) -> Any:
    return _module(arch).reduced()


def get_bundle(arch: str, reduced: bool = False):
    from repro_torch.models.api import bundle_for

    cfg = get_reduced(arch) if reduced else get(arch)
    return bundle_for(arch, cfg)
