"""Checkpoints of the port (``repro/checkpoint``'s layout)."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
from repro_torch.checkpoint.pack import pack_blob, unpack_blob  # noqa: F401
