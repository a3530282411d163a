from .manager import CheckpointManager, load_meta, restore_tree, save_tree

__all__ = ["save_tree", "restore_tree", "load_meta", "CheckpointManager"]
