from .pipeline import DataConfig, TokenPipeline
