from repro_torch.data.pipeline import DataConfig, ShardedLoader, make_source

__all__ = ["DataConfig", "ShardedLoader", "make_source"]
