"""Checkpoints of the port's trees in the reference's on-disk format
(`checkpoint.py`)."""
from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer,  # noqa: F401
                                               latest_step,
                                               restore_checkpoint,
                                               save_checkpoint)
