from .checkpoint import load_index, load_index_shard

__all__ = ["load_index", "load_index_shard"]
