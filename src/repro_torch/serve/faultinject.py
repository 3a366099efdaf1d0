"""Fault-injection hooks for the serving runtime — a stdlib copy of the
JAX package's ``serve.faultinject``, reporting to the port's own
``obs`` registry.

The serving loop's failures are transient device-side events — an OOM
on payload upload, a failed result fetch, a poisoned batch — and the
recovery is a retry, possibly onto the host-planned path: every
engine's results are deterministic functions of (query rows, index),
so re-execution on any path is safe.

Production code *fires* named hook sites; tests and chaos drills *arm*
a :class:`FaultPlan` that decides what happens there. With no plan
armed (the default), every site is a no-op costing one ``None`` check.

Hook sites the port fires:

* ``megastep.payload_upload`` — ``core.megastep.MegastepEngine
  ._refresh``, when the device payload is (re)built and uploaded;
  failing it simulates a device OOM at upload time (nothing is cached).
* ``megastep.fetch`` — just before a device→host result fetch (the
  megastep's and the quantized tier's ``finalize``, and
  ``coarse_shortlist``); failing it simulates a lost fetch.
* ``quant.eps_inflation`` — a *transform* site over the quantized
  tier's certified lower bounds: shrinking them is what inflated ε
  errors would do, so a transform there forces certification failures
  and exercises the fp32 fallback.

* ``sched.dispatch`` — ``serve.scheduler.ServeScheduler``, just before
  it hands a batch to an engine (every attempt of the synchronous retry
  ladder, and the pipelined ``dispatch``); failing it simulates a
  poisoned batch.

* ``sharded.shard_upload`` — the sharded engines' ``_put_shard``
  (``core.sharded``), whenever a shard's piece of the partitioned
  payload is committed to its device; a :class:`ShardFault` naming the
  shard simulates a device lost during the upload.
* ``sharded.shard_compute`` — just before the sharded megastep's launch
  (``ShardedMegastepEngine.dispatch``); a :class:`ShardFault` here is a
  shard dying mid-stream.
* ``sharded.collective`` — a :func:`cross` site over the fetched
  cross-shard merge result (``ShardedMegastepEngine.finalize``):
  ``.fail`` is a poisoned gather, a sleeping ``.transform`` a *hung*
  one, which the engine's ``attempt_timeout`` turns into a
  :class:`ShardFailedError`.

All sites compose in one armed plan.

Usage::

    with FaultPlan().fail("megastep.payload_upload", times=2):
        engine.join_batch(q)      # the first 2 uploads raise InjectedFault

    with FaultPlan().transform("quant.eps_inflation",
                               lambda lb: lb - 1e9):
        engine.join_batch(q)      # every certificate fails -> fallback
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

__all__ = ["FaultPlan", "InjectedFault", "ShardFault", "ShardFailedError",
           "fire", "transform_value", "cross", "retry_with_backoff"]


class InjectedFault(RuntimeError):
    """Raised by an armed hook site — the serving loop treats it exactly
    like the real transient failure it stands in for."""

    def __init__(self, site: str, message: Optional[str] = None):
        super().__init__(message or f"injected fault at {site!r}")
        self.site = site


class ShardFault(InjectedFault):
    """An injected fault attributed to one mesh shard (pass as ``exc=``
    to :meth:`FaultPlan.fail` on a ``sharded.*`` site). The sharded
    engines convert it into a :class:`ShardFailedError` after marking
    the shard failed in their health tracker — anonymous
    :class:`InjectedFault`\\ s on the same sites stay generic transients
    handled by the retry ladder instead."""

    def __init__(self, site: str, *, shard: Optional[int] = None,
                 message: Optional[str] = None):
        super().__init__(site, message
                         or f"injected shard fault at {site!r} "
                            f"(shard {shard})")
        self.shard = shard


class ShardFailedError(RuntimeError):
    """A sharded engine detected a failed/hung shard and updated its
    serving view (failover). Unlike a generic transient, retrying the
    *same* engine is the right response: the next attempt runs on the
    updated owner view (replica failover — still bitwise — or certified
    degraded coverage), not on the host-oracle path. The scheduler
    re-checks deadlines at that failover instant."""

    def __init__(self, shard: Optional[int], message: str):
        super().__init__(message)
        self.shard = shard


class FaultPlan:
    """A per-site schedule of injected failures and value transforms.

    Context-manager armed: sites fire only while the plan is active, and
    ``fired`` counts every hook crossing (armed or not scheduled), so
    tests can assert a site was actually reached. Thread-safe — the
    serving loop fires from worker threads.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._fail: Dict[str, list] = {}        # site -> [remaining, exc]
        self._transform: Dict[str, Callable] = {}
        self.fired: Dict[str, int] = {}

    # ---- arming ----------------------------------------------------

    def fail(self, site: str, *, times: int = 1,
             exc: Optional[Exception] = None) -> "FaultPlan":
        """The next ``times`` crossings of ``site`` raise (``exc`` or an
        :class:`InjectedFault`); later crossings pass."""
        self._fail[site] = [int(times), exc]
        return self

    def transform(self, site: str, fn: Callable[[Any], Any]) -> "FaultPlan":
        """Every crossing of the transform site maps its value through
        ``fn`` (e.g. deflate certified bounds = inflate ε)."""
        self._transform[site] = fn
        return self

    # ---- the hook side ---------------------------------------------

    def _fire(self, site: str) -> None:
        from .. import obs
        with self._lock:
            self.fired[site] = self.fired.get(site, 0) + 1
            ent = self._fail.get(site)
            if ent is None or ent[0] <= 0:
                obs.metrics.REGISTRY.counter(
                    "fault_crossings_total", site=site).inc()
                return
            ent[0] -= 1
            exc = ent[1]
        reg = obs.metrics.REGISTRY
        reg.counter("fault_crossings_total", site=site).inc()
        reg.counter("fault_injected_total", site=site).inc()
        obs.event("fault.injected", site=site)
        raise exc if exc is not None else InjectedFault(site)

    def _transform_value(self, site: str, value):
        from .. import obs
        with self._lock:
            self.fired[site] = self.fired.get(site, 0) + 1
            fn = self._transform.get(site)
        reg = obs.metrics.REGISTRY
        reg.counter("fault_crossings_total", site=site).inc()
        if fn is None:
            return value
        reg.counter("fault_injected_total", site=site).inc()
        obs.event("fault.injected", site=site, kind="transform")
        return fn(value)

    def _cross(self, site: str, value):
        """fire + transform as ONE counted crossing (see :func:`cross`):
        a scheduled failure wins; otherwise an armed transform maps the
        value through (and may sleep — a hang — or raise itself)."""
        from .. import obs
        exc = fn = None
        with self._lock:
            self.fired[site] = self.fired.get(site, 0) + 1
            ent = self._fail.get(site)
            if ent is not None and ent[0] > 0:
                ent[0] -= 1
                exc = ent[1] if ent[1] is not None else InjectedFault(site)
            else:
                fn = self._transform.get(site)
        reg = obs.metrics.REGISTRY
        reg.counter("fault_crossings_total", site=site).inc()
        if exc is not None:
            reg.counter("fault_injected_total", site=site).inc()
            obs.event("fault.injected", site=site)
            raise exc
        if fn is None:
            return value
        reg.counter("fault_injected_total", site=site).inc()
        obs.event("fault.injected", site=site, kind="transform")
        return fn(value)

    # ---- arming scope ----------------------------------------------

    def __enter__(self) -> "FaultPlan":
        global _PLAN
        if _PLAN is not None:
            raise RuntimeError("a FaultPlan is already armed")
        _PLAN = self
        return self

    def __exit__(self, *exc) -> bool:
        global _PLAN
        _PLAN = None
        return False


_PLAN: Optional[FaultPlan] = None


def fire(site: str) -> None:
    """Production-side hook: raise if an armed plan scheduled a failure
    here; free (one None check) otherwise."""
    plan = _PLAN
    if plan is not None:
        plan._fire(site)


def transform_value(site: str, value):
    """Production-side transform hook: map ``value`` through the armed
    plan's transform for ``site`` (identity when unarmed)."""
    plan = _PLAN
    if plan is None:
        return value
    return plan._transform_value(site, value)


def cross(site: str, value=None):
    """Combined production-side hook for sites that can both *fail*
    (``FaultPlan.fail``) and be *value-warped or delayed*
    (``FaultPlan.transform``) — e.g. ``sharded.collective``, where a
    fail is a poisoned all-gather and a sleeping transform is a hung
    one. One counted crossing either way; identity when unarmed."""
    plan = _PLAN
    if plan is None:
        return value
    return plan._cross(site, value)


def retry_with_backoff(fn: Callable[[int], Any], *, max_retries: int,
                       base_s: float, cap_s: float,
                       sleep: Callable[[float], None] = time.sleep,
                       retriable: tuple = (Exception,)):
    """Capped-exponential-backoff retry driver — the serving-loop
    analogue of ``distributed.fault.GroupExecutor``'s bounded re-issue.

    Calls ``fn(attempt)`` (attempt 0 = first try); on a retriable
    failure sleeps ``min(base_s * 2**attempt, cap_s)`` and re-calls
    with the next attempt number — the callee routes later attempts
    onto a safer path (the host-planned oracle). Raises the last error
    after ``max_retries`` retries.
    """
    attempt = 0
    while True:
        try:
            return fn(attempt)
        except retriable:
            if attempt >= max_retries:
                raise
            sleep(min(base_s * (2.0 ** attempt), cap_s))
            attempt += 1
