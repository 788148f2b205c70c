from .checkpoint import (all_steps, latest_step, load_index,
                         load_index_shard, restore_checkpoint,
                         save_checkpoint, save_index, wait_async)

__all__ = ["all_steps", "latest_step", "load_index", "load_index_shard",
           "restore_checkpoint", "save_checkpoint", "save_index",
           "wait_async"]
