"""Checkpoints of training state (``CheckpointManager``)."""
from repro_torch.checkpoint.checkpointing import CheckpointManager

__all__ = ["CheckpointManager"]
