"""The port's optimizer: AdamW with the reference's arithmetic."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_update,  # noqa: F401
                                     global_norm, init_opt_state, schedule)
