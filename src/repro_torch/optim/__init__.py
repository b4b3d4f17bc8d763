"""Optimizers of the port and int8 gradient compression."""

from repro_torch.optim.adamw import (AdamWCfg, adamw_update, cosine_schedule,
                                     global_norm, init_opt_state,
                                     logicnet_mask_fn)
from repro_torch.optim.compress import (compress_grads_with_feedback,
                                        compress_int8, decompress_int8,
                                        init_error_state)

__all__ = ["AdamWCfg", "adamw_update", "compress_grads_with_feedback",
           "compress_int8", "cosine_schedule", "decompress_int8",
           "global_norm", "init_error_state", "init_opt_state",
           "logicnet_mask_fn"]
