"""Serving of the PyTorch port (see repro_torch): the engine, its request
handles and queue, and the one config surface of its launchers.

The reference's exports, resolved on first use: ``kernels.ref`` imports
``serving.kv_pool`` while the model modules load, so importing the engine
here eagerly would be circular."""
import importlib

_EXPORTS = {"EngineConfig": "config", "ServingEngine": "engine", "Request": "engine",
            "Completion": "engine", "QueueFull": "handles", "RequestHandle": "handles",
            "TenantQueue": "handles"}

__all__ = ["ServingEngine", "Request", "Completion", "RequestHandle",
           "QueueFull", "TenantQueue", "EngineConfig"]


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
