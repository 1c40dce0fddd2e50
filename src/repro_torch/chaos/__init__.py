"""Deterministic fault injection for the training runtimes (``repro/chaos``)."""
from repro_torch.chaos.injector import (  # noqa: F401
    ChaosError,
    ChaosEvent,
    ChaosInjector,
    ChaosPlan,
    InjectedWorkerDeath,
)
