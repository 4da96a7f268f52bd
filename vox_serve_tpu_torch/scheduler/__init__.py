"""Scheduler registry of the port (vox_serve_tpu/scheduler/__init__.py):
base, online, offline, input_streaming and disaggregation."""

from .base import Scheduler
from .disaggregation import DisaggregationScheduler
from .input_streaming import InputStreamingScheduler
from .offline import OfflineScheduler
from .online import OnlineScheduler

SCHEDULER_REGISTRY: dict[str, type[Scheduler]] = {
    "base": Scheduler,
    "online": OnlineScheduler,
    "offline": OfflineScheduler,
    "input_streaming": InputStreamingScheduler,
    "disaggregation": DisaggregationScheduler,
}


def register_scheduler(name: str, cls: type[Scheduler]) -> None:
    SCHEDULER_REGISTRY[name] = cls


def load_scheduler(scheduler_type: str, **kwargs) -> Scheduler:
    try:
        cls = SCHEDULER_REGISTRY[scheduler_type]
    except KeyError:
        raise ValueError(
            f"unknown scheduler type {scheduler_type!r}; "
            f"available: {sorted(SCHEDULER_REGISTRY)}"
        ) from None
    return cls(**kwargs)
