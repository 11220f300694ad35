"""Carry the reference's weights into the port.

The reference's param tree, with its leaves as numpy arrays (the caller
makes them with ``jax.tree_util.tree_map(np.asarray, params)``), has the
port's structure and layouts already: nested dicts, blocks stacked on a
leading L axis, ``wq`` [d,H,hd] and so on.  Conversion is leaf by leaf.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from .transformer import TransformerConfig, check_supported

__all__ = ["params_from_jax"]


def params_from_jax(np_tree: Any, cfg: TransformerConfig,
                    device: str | torch.device = "cuda",
                    dtype=torch.float32) -> Any:
    """Numpy param tree -> the port's param tree on ``device``.

    Floating leaves (including bfloat16 ones) become ``dtype``; integer
    leaves keep their type.
    """
    check_supported(cfg)
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        a = np.asarray(x)
        if a.dtype.kind in "iub":
            return torch.from_numpy(np.array(a)).to(dev)
        # a copy: the source buffer may be read-only, and bfloat16 leaves are
        # an extension type numpy cannot hand to torch as they are
        return torch.from_numpy(np.array(a, np.float32)).to(device=dev, dtype=dtype)

    return conv(np_tree)
