from .adamw import AdamWConfig, adamw_init, adamw_update, cosine_schedule, global_norm

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule", "global_norm"]
