"""Optimizers — port of `repro.optim`."""
from .adamw import adamw_init, adamw_update, sgdm_init, sgdm_update

__all__ = ["adamw_init", "adamw_update", "sgdm_init", "sgdm_update"]
