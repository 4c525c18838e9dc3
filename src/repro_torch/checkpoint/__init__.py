from .ckpt import (latest_step, latest_store_step, leaf_paths, restore,
                   restore_store, save, save_store)

__all__ = ["latest_step", "latest_store_step", "leaf_paths", "restore",
           "restore_store", "save", "save_store"]
