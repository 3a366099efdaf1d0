"""Span tracer — the serving stack's flight recorder.

A :class:`Tracer` records structured **spans** (named, wall-clocked,
attributed, parent-linked) into a bounded ring buffer. Production code
brackets its stages with :func:`span` / stamps instants with
:func:`event`; both are **off by default** and cost one module-global
load plus a ``None`` check when no tracer is installed — the same
contract as ``serve.faultinject.fire``, so the instrumentation can live
permanently on the hot path.

Design constraints, in order:

* **zero-steady-state-host-sync safe** — recording a span touches the
  monotonic clock and a deque, never a device value. Attribute values
  must already be host-side Python/ints (callers attach sizes, config
  knobs and ``JoinStats`` fields — never CUDA tensors, whose
  conversion to a Python value would synchronise inside the fused path).
* **thread-safe** — the serving loop spans from the consumer thread
  while ``submit`` spans from callers; ``deque.append`` with ``maxlen``
  is atomic under the GIL and the per-thread open-span stack lives in
  ``threading.local``. Parent links therefore never cross threads —
  cross-thread causality is carried by the ``tickets`` attribute
  instead (see ``obs.export.explain``).
* **bounded** — the ring buffer drops the *oldest* spans past
  ``capacity``; a forgotten enabled tracer degrades to a sliding
  window, never to unbounded growth.

Usage::

    from repro_torch import obs

    with obs.capture() as tr:                 # install + auto-uninstall
        scheduler.join_now(q)
    obs.export.write_chrome_trace(tr.spans(), "trace.json")

    with obs.trace.span("my.stage", rows=n) as sp:   # in production code
        ...
        sp.set(outcome="ok")                  # attach attrs discovered late
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["NULL_SPAN", "Span", "Tracer", "capture", "current", "enabled",
           "event", "install", "span", "uninstall"]


class Span:
    """One recorded operation: ``[t0, t1)`` on the monotonic clock, with
    a name, an id, a same-thread parent id (0 = root) and a free-form
    attribute dict. Mutable while open (``set``), frozen by convention
    once it lands in the ring buffer."""

    __slots__ = ("name", "span_id", "parent_id", "t0", "t1", "thread",
                 "attrs")

    def __init__(self, name: str, span_id: int, parent_id: int,
                 t0: float, thread: int, attrs: dict):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.t1 = t0
        self.thread = thread
        self.attrs = attrs

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def set(self, **attrs) -> "Span":
        """Attach attributes discovered after the span opened (stage
        outcomes, per-attempt ``JoinStats`` numbers)."""
        self.attrs.update(attrs)
        return self

    def to_dict(self) -> dict:
        return dict(name=self.name, span_id=self.span_id,
                    parent_id=self.parent_id, t0=self.t0, t1=self.t1,
                    thread=self.thread, attrs=dict(self.attrs))

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.duration_s * 1e6:.1f}us, "
                f"attrs={self.attrs!r})")


class _SpanCtx:
    """Context manager that opens a :class:`Span` on ``__enter__`` and
    records it on ``__exit__`` (ring-buffer append, stack pop)."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self._span = Span(name, next(tracer._ids),
                          tracer._stack_top(), 0.0,
                          threading.get_ident(), attrs)

    def __enter__(self) -> Span:
        sp = self._span
        self._tracer._push(sp)
        sp.t0 = sp.t1 = time.perf_counter()
        return sp

    def __exit__(self, exc_type, exc, tb) -> bool:
        sp = self._span
        sp.t1 = time.perf_counter()
        if exc_type is not None and "outcome" not in sp.attrs:
            sp.attrs["outcome"] = f"error:{exc_type.__name__}"
        self._tracer._pop(sp)
        return False


class _NullSpan:
    """The disabled path's shared no-op: context manager and ``set``
    sink in one. A single instance serves every call site."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Tracer:
    """Ring-buffer span recorder. Create one per capture (or one
    long-lived per process) and :func:`install` it; ``capacity`` bounds
    retained spans (oldest dropped first)."""

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._buf: deque = deque(maxlen=self.capacity)
        self._ids = itertools.count(1)
        self._local = threading.local()

    # ---- per-thread open-span stack (parent linkage) ----------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _stack_top(self) -> int:
        st = getattr(self._local, "stack", None)
        return st[-1].span_id if st else 0

    def _push(self, sp: Span) -> None:
        self._stack().append(sp)

    def _pop(self, sp: Span) -> None:
        st = self._stack()
        if st and st[-1] is sp:
            st.pop()
        elif sp in st:                       # unbalanced exit: best effort
            st.remove(sp)
        self._buf.append(sp)

    # ---- recording ---------------------------------------------------

    def span(self, name: str, **attrs) -> _SpanCtx:
        """Open a timed span: ``with tracer.span("stage", n=5) as sp:``."""
        return _SpanCtx(self, name, attrs)

    def event(self, name: str, **attrs) -> Span:
        """Record an instant (zero-duration span) immediately."""
        sp = Span(name, next(self._ids), self._stack_top(),
                  time.perf_counter(), threading.get_ident(), attrs)
        self._buf.append(sp)
        return sp

    # ---- inspection --------------------------------------------------

    def spans(self) -> List[Span]:
        """Snapshot of recorded spans, oldest first (open spans are not
        included — they land on exit)."""
        return list(self._buf)

    def clear(self) -> None:
        self._buf.clear()

    def __len__(self) -> int:
        return len(self._buf)


# ---------------------------------------------------------------------------
# module-global installation — the production hook side

_TRACER: Optional[Tracer] = None


def install(tracer: Optional[Tracer] = None) -> Tracer:
    """Install ``tracer`` (a fresh default one when ``None``) as the
    process-global recorder. Returns it. Nested installs replace."""
    global _TRACER
    if tracer is None:
        tracer = Tracer()
    _TRACER = tracer
    return tracer


def uninstall() -> None:
    """Disable tracing: every later :func:`span`/:func:`event` goes back
    to the one-``None``-check fast path."""
    global _TRACER
    _TRACER = None


def current() -> Optional[Tracer]:
    return _TRACER


def enabled() -> bool:
    return _TRACER is not None


def span(name: str, **attrs):
    """Production-side hook: a timed span when a tracer is installed,
    the shared :data:`NULL_SPAN` no-op otherwise."""
    tr = _TRACER
    if tr is None:
        return NULL_SPAN
    return tr.span(name, **attrs)


def event(name: str, **attrs) -> Optional[Span]:
    """Production-side hook: record an instant when tracing is enabled;
    free (one ``None`` check) otherwise."""
    tr = _TRACER
    if tr is None:
        return None
    return tr.event(name, **attrs)


class capture:
    """Scoped tracing: installs a fresh :class:`Tracer` on entry and
    uninstalls on exit — the test/bench form.

    ::

        with obs.capture() as tr:
            sched.join_now(q)
        assert any(s.name == "serve.attempt" for s in tr.spans())
    """

    def __init__(self, capacity: int = 65536):
        self.tracer = Tracer(capacity)
        self._prev: Optional[Tracer] = None

    def __enter__(self) -> Tracer:
        global _TRACER
        self._prev = _TRACER
        _TRACER = self.tracer
        return self.tracer

    def __exit__(self, *exc) -> bool:
        global _TRACER
        _TRACER = self._prev
        return False
