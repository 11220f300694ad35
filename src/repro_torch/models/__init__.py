"""Model families: the decoder-only transformer (dense GQA)."""

from . import transformer
from .api import ModelBundle, bundle_for

__all__ = ["ModelBundle", "bundle_for", "transformer"]
