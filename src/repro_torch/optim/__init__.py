"""Optimizers of the training path: AdamW with latent clipping, signSGD
with error feedback, the cosine schedule (the reference's ``optim/``)."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compress import signsgd_ef_init, signsgd_ef_compress
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "signsgd_ef_init", "signsgd_ef_compress", "cosine_schedule"]
