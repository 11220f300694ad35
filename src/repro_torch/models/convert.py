"""Carry the reference's weights into the port.

The reference's param tree, with its leaves as numpy arrays (the caller
makes them with ``jax.tree_util.tree_map(np.asarray, params)``), has the
port's structure and layouts already: nested dicts, blocks stacked on a
leading L axis (Griffin: ``groups`` stacked per pattern position and a
``tail`` list; DeepSeek-V2: a ``lead_blocks`` list), ``wq`` [d,H,hd] and
so on.  Conversion is leaf by leaf.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["params_from_jax"]


def params_from_jax(np_tree: Any, cfg: Any,
                    device: str | torch.device = "cuda",
                    dtype=torch.float32) -> Any:
    """Numpy param tree of any ported family -> the port's tree on ``device``.

    Floating leaves (including bfloat16 ones) become ``dtype``, except MoE
    routers, which stay float32 as the reference keeps them; integer leaves
    keep their type; lists stay lists.  ``cfg`` names the family the tree
    belongs to; the conversion itself does not depend on it.
    """
    del cfg
    dev = resolve_device(device)

    def conv(x, name=""):
        if isinstance(x, dict):
            return {k: conv(v, k) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        a = np.asarray(x)
        if a.dtype.kind in "iub":
            return torch.from_numpy(np.array(a)).to(dev)
        # a copy: the source buffer may be read-only, and bfloat16 leaves are
        # an extension type numpy cannot hand to torch as they are
        to = torch.float32 if name == "router" else dtype
        return torch.from_numpy(np.array(a, np.float32)).to(device=dev, dtype=to)

    return conv(np_tree)
