"""Observability for the port — the flight recorder's tracer, metrics
and exporters.

A copy of the JAX package's stdlib-only ``obs.trace``, ``obs.metrics``
and ``obs.export`` with the same span and metric names. It keeps its
own process-global ``metrics.REGISTRY``, so the two packages' metrics
never mix. ``export`` renders spans as JSONL or a Chrome trace
(Perfetto-loadable), the registry as Prometheus text, and one request's
span tree (``explain(ticket)``).

The invariant the instrumentation honors: **zero steady-state host
syncs**. Span attributes carry only host-side values, never a CUDA
tensor a recorder would have to read back.
"""
from . import export, metrics, trace
from .export import (ExplainNode, chrome_trace, explain, format_explain,
                     render_prometheus, spans_to_jsonl, write_chrome_trace,
                     write_jsonl)
from .metrics import Registry
from .trace import Tracer, capture, enabled, event, install, span, uninstall

# the live default registry is ``metrics.REGISTRY`` — accessed through
# the module on purpose, so ``metrics.scoped()`` can swap it
__all__ = ["ExplainNode", "Registry", "Tracer", "capture", "chrome_trace",
           "enabled", "event", "explain", "export", "format_explain",
           "install", "metrics", "render_prometheus", "span",
           "spans_to_jsonl", "trace", "uninstall", "write_chrome_trace",
           "write_jsonl"]
