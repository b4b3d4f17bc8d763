"""Optimizers of the port."""

from repro_torch.optim.adamw import (AdamWCfg, adamw_update, cosine_schedule,
                                     global_norm, init_opt_state)

__all__ = ["AdamWCfg", "adamw_update", "cosine_schedule", "global_norm",
           "init_opt_state"]
