from repro_torch.optim.adamw import (adamw_init, adamw_update, clip_by_global_norm,
                                     cosine_schedule, linear_warmup_cosine)

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule", "linear_warmup_cosine"]
