from .checkpoint import load_index, load_index_shard, save_index, wait_async

__all__ = ["load_index", "load_index_shard", "save_index", "wait_async"]
