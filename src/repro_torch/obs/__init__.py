"""Observability for the port — the flight recorder's tracer and metrics.

A copy of the JAX package's stdlib-only ``obs.trace`` and ``obs.metrics``
with the same span and metric names. It keeps its own process-global
``metrics.REGISTRY``, so the two packages' metrics never mix.

The invariant the instrumentation honors: **zero steady-state host
syncs**. Span attributes carry only host-side values, never a CUDA
tensor a recorder would have to read back.
"""
from . import metrics, trace
from .metrics import Registry
from .trace import Tracer, capture, enabled, event, install, span, uninstall

# the live default registry is ``metrics.REGISTRY`` — accessed through
# the module on purpose, so ``metrics.scoped()`` can swap it
__all__ = ["Registry", "Tracer", "capture", "enabled", "event", "install",
           "metrics", "span", "trace", "uninstall"]
