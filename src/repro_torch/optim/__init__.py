"""AdamW, the cosine schedule and error-feedback gradient compression (the
port of ``repro.optim``)."""
from .adamw import AdamWState, adamw_init, adamw_update
from .schedule import cosine_schedule

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule"]
