from .pipeline import DataConfig, SyntheticTokens

__all__ = ["DataConfig", "SyntheticTokens"]
