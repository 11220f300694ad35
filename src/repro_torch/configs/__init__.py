"""Architecture registry of the port.

``get(arch_id)`` returns the full production config; ``get_reduced`` returns
the same family at smoke-test scale; ``get_bundle`` wraps either in the
unified ModelBundle API.  The port carries the architectures whose family it
runs so far: the paper's Llama3-8B (transformer), mamba2-1.3b (Mamba-2,
kernel K4) and recurrentgemma-9b (Griffin, kernels K5 and K1).
"""

from __future__ import annotations

from importlib import import_module
from typing import Any

_MODULES = {
    "llama3-8b": "llama3_8b",
    "mamba2-1.3b": "mamba2_1_3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}

ALL_ARCHS = tuple(_MODULES)


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
