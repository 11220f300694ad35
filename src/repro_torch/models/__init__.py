"""Model families: the decoder-only transformer (dense GQA), with its
prefill + KV-cache decode serving path."""

from . import transformer, transformer_serve
from .api import ModelBundle, bundle_for

__all__ = ["ModelBundle", "bundle_for", "transformer", "transformer_serve"]
