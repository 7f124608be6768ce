from .pipeline import DataConfig, SyntheticLM, make_source, shard_batch

__all__ = ["DataConfig", "SyntheticLM", "make_source", "shard_batch"]
