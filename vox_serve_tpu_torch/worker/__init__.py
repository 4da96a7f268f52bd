from .base import ModelWorker, WorkerConfig  # noqa: F401
