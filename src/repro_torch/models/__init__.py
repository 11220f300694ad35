"""Model families: the composable transformer (dense GQA, MoE, MLA) with its
prefill + KV-cache decode serving path, Mamba-2 SSD and the Griffin hybrid."""

from . import griffin, mamba2, transformer, transformer_serve
from .api import SHAPES, ModelBundle, ShapeSpec, bundle_for

__all__ = ["SHAPES", "ModelBundle", "ShapeSpec", "bundle_for", "griffin",
           "mamba2", "transformer", "transformer_serve"]
