from .pipeline import DataConfig, TokenPipeline

__all__ = ["DataConfig", "TokenPipeline"]
