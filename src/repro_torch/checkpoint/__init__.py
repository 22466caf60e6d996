"""Checkpointing: save and restore with atomic completion."""
from .checkpoint import Stacked, latest_step, restore_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "Stacked"]
