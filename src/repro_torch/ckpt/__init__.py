from .checkpoint import load_index, load_index_shard, save_index

__all__ = ["load_index", "load_index_shard", "save_index"]
