"""The port's optimizer and LR schedules (`repro.optim`)."""
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.schedules import cosine, wsd

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine", "wsd"]
