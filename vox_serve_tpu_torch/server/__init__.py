from .api import APIServer  # noqa: F401
