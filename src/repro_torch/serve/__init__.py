"""Serving, PyTorch port of the JAX package's ``serve``: batched
generation (``serve_step``), the kNN-LM datastore (``retrieval``), the
deadline-aware request scheduler (``scheduler``) and the
fault-injection hooks (``faultinject``).

Lazy (PEP 562) exports: ``core.megastep`` fires ``faultinject`` sites,
so importing this package must stay light.
"""
import importlib

_EXPORTS = {
    "BatchedServer": "serve_step",
    "ServeConfig": "serve_step",
    "make_serve_step": "serve_step",
    "make_knn_hook": "serve_step",
    "sample": "serve_step",
    "Datastore": "retrieval",
    "KnnLMConfig": "retrieval",
    "interpolate": "retrieval",
    "knn_logits": "retrieval",
    "FaultPlan": "faultinject",
    "InjectedFault": "faultinject",
    "ShardFault": "faultinject",
    "ShardFailedError": "faultinject",
    "Arrival": "scheduler",
    "LoadReport": "scheduler",
    "Priority": "scheduler",
    "SchedulerConfig": "scheduler",
    "SchedulerStats": "scheduler",
    "ServeScheduler": "scheduler",
    "Ticket": "scheduler",
    "VirtualClock": "scheduler",
    "bursty_times": "scheduler",
    "poisson_times": "scheduler",
    "run_open_loop": "scheduler",
}

_MODULES = ("faultinject", "retrieval", "scheduler", "serve_step")
__all__ = sorted(_EXPORTS) + list(_MODULES)


def __getattr__(name):
    if name in _MODULES:
        return importlib.import_module(f".{name}", __name__)
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)


def __dir__():
    return __all__
