"""Trainers: the three-graph GAN protocol engine, the CV and insurance
programs, the roadmap families, the fleet and its tenant lifecycle.  The
names below are imported on first use, so importing one submodule does
not import the others."""

import importlib

_EXPORTS = {
    "EarlyStoppingConfig": "early_stopping",
    "EarlyStoppingGraphTrainer": "early_stopping",
    "EarlyStoppingResult": "early_stopping",
    "GANTrainer": "gan_trainer",
    "GANTrainerConfig": "gan_trainer",
    "Workload": "gan_trainer",
    "PreemptionError": "preemption",
    "PreemptionGuard": "preemption",
    "FleetConfig": "fleet",
    "FleetTrainer": "fleet",
    "DEFAULT_TENANT_BUCKETS": "lifecycle",
    "FleetHealthSentinel": "lifecycle",
    "FleetManager": "lifecycle",
    "LifecycleConfig": "lifecycle",
    "LifecycleFleetTrainer": "lifecycle",
    "TenantSpec": "lifecycle",
    "bucket_for": "lifecycle",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
