"""Exporters for the flight recorder: JSONL spans, Chrome trace events
(Perfetto-loadable), Prometheus text metrics, and the per-query
``explain`` span-tree reconstruction — a stdlib copy of the JAX
package's ``obs.export`` over the port's own tracer and registry.

All exporters are read-only views over ``Tracer.spans()`` /
``Registry`` snapshots — nothing here touches devices or the serving
hot path.
"""
from __future__ import annotations

import json
from typing import IO, List, Optional, Sequence, Union

from .metrics import Histogram, Registry
from .trace import Span, Tracer, current

__all__ = ["ExplainNode", "chrome_trace", "explain", "format_explain",
           "render_prometheus", "spans_to_jsonl", "write_chrome_trace",
           "write_jsonl"]


def _json_safe(v):
    """Span attributes may carry numpy or torch scalars and tuples; make
    them JSON-clean without importing either (duck-typed via
    ``item()``)."""
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    item = getattr(v, "item", None)
    if callable(item):
        try:
            return _json_safe(v.item())
        except (ValueError, TypeError):
            pass
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    return repr(v)


# ---------------------------------------------------------------------------
# JSONL span dump


def spans_to_jsonl(spans: Sequence[Span]) -> str:
    """One JSON object per line per span — the grep/jq-friendly dump."""
    lines = []
    for sp in spans:
        d = sp.to_dict()
        d["attrs"] = _json_safe(d["attrs"])
        lines.append(json.dumps(d, sort_keys=True))
    return "\n".join(lines) + ("\n" if lines else "")


def write_jsonl(spans: Sequence[Span], path_or_file: Union[str, IO]) -> None:
    text = spans_to_jsonl(spans)
    if hasattr(path_or_file, "write"):
        path_or_file.write(text)
        return
    with open(path_or_file, "w") as fh:
        fh.write(text)


# ---------------------------------------------------------------------------
# Chrome trace-event format (load in Perfetto / chrome://tracing)


def chrome_trace(spans: Sequence[Span]) -> dict:
    """Complete ("X"-phase) trace events, microsecond timestamps, one
    Perfetto track per recording thread. Instants (zero-duration spans)
    render as "i"-phase marks so failovers/deadline-rechecks show up as
    flags on the timeline."""
    events = []
    for sp in spans:
        args = _json_safe(sp.attrs) or {}
        args["span_id"] = sp.span_id
        if sp.parent_id:
            args["parent_id"] = sp.parent_id
        ev = dict(name=sp.name, pid=0, tid=sp.thread,
                  ts=sp.t0 * 1e6, args=args)
        if sp.t1 > sp.t0:
            ev["ph"] = "X"
            ev["dur"] = (sp.t1 - sp.t0) * 1e6
        else:
            ev["ph"] = "i"
            ev["s"] = "t"          # thread-scoped instant
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(spans: Sequence[Span],
                       path_or_file: Union[str, IO]) -> None:
    doc = chrome_trace(spans)
    if hasattr(path_or_file, "write"):
        json.dump(doc, path_or_file)
        return
    with open(path_or_file, "w") as fh:
        json.dump(doc, fh)


# ---------------------------------------------------------------------------
# Prometheus text rendering


def render_prometheus(registry: Registry) -> str:
    """Prometheus exposition text format v0.0.4: counters/gauges as-is,
    histograms as cumulative ``_bucket{le=...}`` series + ``_sum`` /
    ``_count`` (quantiles are the scraper's job there; use
    ``Registry.snapshot()`` for the precomputed p50/p99/p999)."""
    out: List[str] = []
    seen_types = set()
    for m in registry.metrics():
        if m.name not in seen_types:
            out.append(f"# TYPE {m.name} {m.kind}")
            seen_types.add(m.name)
        labels = dict(m.labels)
        if isinstance(m, Histogram):
            cum = 0
            counts = m.bucket_counts()
            for bound, c in zip(m.bounds, counts):
                cum += c
                lab = _fmt_labels({**labels, "le": _fmt_float(bound)})
                out.append(f"{m.name}_bucket{lab} {cum}")
            cum += counts[-1]
            lab = _fmt_labels({**labels, "le": "+Inf"})
            out.append(f"{m.name}_bucket{lab} {cum}")
            base = _fmt_labels(labels)
            out.append(f"{m.name}_sum{base} {_fmt_float(m.sum)}")
            out.append(f"{m.name}_count{base} {m.count}")
        else:
            out.append(f"{m.name}{_fmt_labels(labels)} "
                       f"{_fmt_float(m.value)}")
    return "\n".join(out) + ("\n" if out else "")


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_float(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


# ---------------------------------------------------------------------------
# per-query explain: reconstruct one request's span tree


class ExplainNode:
    """One span plus its children, ordered by start time."""

    __slots__ = ("span", "children")

    def __init__(self, span: Span):
        self.span = span
        self.children: List[ExplainNode] = []

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


def _matches_ticket(sp: Span, tid: int) -> bool:
    a = sp.attrs
    if a.get("ticket") == tid:
        return True
    ts = a.get("tickets")
    return ts is not None and tid in ts


def explain(ticket, spans: Optional[Sequence[Span]] = None, *,
            tracer: Optional[Tracer] = None) -> List[ExplainNode]:
    """Reconstruct one request's span tree from the flight recorder.

    ``ticket`` is a ``serve.scheduler.Ticket`` or its integer
    ``ticket_id``. Spans whose ``ticket``/``tickets`` attribute names
    the request are selected as anchors, then every recorded descendant
    (engine stages, collectives, fault events — which carry no ticket
    attribution of their own but parent-link into the scheduler spans)
    is pulled in. Returns the roots in start order — typically
    ``serve.admission`` → ``serve.coalesce`` → one ``serve.attempt``
    per dispatch (with megastep/sharded/quant stages below each) →
    retry / failover entries, reading as the request's life story.

    Raises ``ValueError`` when no tracer is available (spans must come
    from somewhere: pass ``spans=``, ``tracer=``, or have one
    installed)."""
    tid = getattr(ticket, "ticket_id", ticket)
    if not isinstance(tid, int):
        raise TypeError(f"want a Ticket or int ticket_id, got {ticket!r}")
    if spans is None:
        tr = tracer or current()
        if tr is None:
            raise ValueError(
                "no spans to explain from: no tracer installed — wrap "
                "the request in repro_torch.obs.capture() (or pass spans=)")
        spans = tr.spans()
    anchors = {sp.span_id for sp in spans if _matches_ticket(sp, tid)}
    if not anchors:
        return []
    # pull in descendants of anchored spans (children carry parent_id
    # but no ticket attribution of their own)
    children_of: dict = {}
    for sp in spans:
        children_of.setdefault(sp.parent_id, []).append(sp)
    selected = set(anchors)
    frontier = list(anchors)
    while frontier:
        pid = frontier.pop()
        for ch in children_of.get(pid, ()):
            if ch.span_id not in selected:
                selected.add(ch.span_id)
                frontier.append(ch.span_id)
    chosen = [sp for sp in spans if sp.span_id in selected]
    nodes = {sp.span_id: ExplainNode(sp) for sp in chosen}
    roots: List[ExplainNode] = []
    for sp in sorted(chosen, key=lambda s: (s.t0, s.span_id)):
        parent = nodes.get(sp.parent_id)
        if parent is not None and sp.parent_id != sp.span_id:
            parent.children.append(nodes[sp.span_id])
        else:
            roots.append(nodes[sp.span_id])
    return roots


def format_explain(roots: Sequence[ExplainNode]) -> str:
    """Render an :func:`explain` forest as an indented text tree with
    durations and attributes — the human-readable incident-audit form."""
    lines: List[str] = []

    def fmt_attrs(attrs: dict) -> str:
        if not attrs:
            return ""
        parts = []
        for k in sorted(attrs):
            v = attrs[k]
            if isinstance(v, float):
                v = f"{v:.4g}"
            parts.append(f"{k}={v}")
        return "  [" + " ".join(parts) + "]"

    def walk(node: ExplainNode, depth: int) -> None:
        sp = node.span
        dur = (f"{sp.duration_s * 1e3:.3f}ms" if sp.t1 > sp.t0
               else "instant")
        lines.append(f"{'  ' * depth}{sp.name}  {dur}"
                     f"{fmt_attrs(sp.attrs)}")
        for c in node.children:
            walk(c, depth + 1)

    for r in roots:
        walk(r, 0)
    return "\n".join(lines)
