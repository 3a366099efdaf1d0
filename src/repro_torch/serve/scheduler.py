"""Overload-robust request scheduling in front of the join engines —
PyTorch port of the JAX package's ``serve.scheduler``.

The compute side of serving (pruned schedules, the fused megastep, the
certified int8 tier) executes whatever batch it is handed; this module
decides *what gets handed to it* when demand exceeds capacity. A
``ServeScheduler`` sits in front of a
``StreamJoinEngine`` (or a ``serve.Datastore``'s resident engine) and
provides:

* **bounded admission with backpressure** — queued rows are capped;
  a request that does not fit is rejected *explicitly* (``Ticket.status
  == "rejected"``) instead of growing an unbounded queue. Interactive
  requests may evict queued bulk work to get in.
* **per-request deadlines, enforced before dispatch** — a deadline
  propagates from submit through batch formation to the device call;
  an expired request is shed *before* it reaches the engine, never
  after (``SchedulerStats.n_expired_dispatched`` counts violations of
  this invariant; it must stay zero).
* **priority lanes** — latency-sensitive decode traffic
  (``Priority.INTERACTIVE``) always dispatches ahead of bulk/backfill
  (``Priority.BULK``); under overload, bulk is shed first.
* **coalescing** — ragged arrivals are packed into one engine batch up
  to ``SchedulerConfig.batch_rows``, so the pow2 padding the megastep
  applies per batch pads *one* coalesced batch instead of every tiny
  request. Exactness makes this free: every engine's per-query result
  is independent of batch composition (the bitwise batched == one-shot
  contract), so coalesced results split back to requests unchanged.
* **graceful degradation instead of collapse** — the ladder is
  exact → certified-approximate → shed. When the backlog passes
  ``degrade_queued_rows`` and a quantized engine is available, batches
  run the coarse-only path (``QuantMegastepEngine.join_batch_approx``):
  no oracle fallback re-runs, and every response carries a *certified*
  per-query recall lower bound derived from the int8 tier's ε machinery
  (contrast with AkNN systems that approximate silently). Past
  ``shed_queued_rows``, queued bulk is shed with an explicit rejection.
* **fault-injected retries** — transient failures (device OOM on
  payload upload, failed fetch, poisoned batch — see
  ``serve.faultinject`` for the hook sites) are retried with capped
  exponential backoff onto the *host-planned oracle path*
  (``StreamJoinEngine.join_batch_host``), which owns no device payload
  and therefore cannot re-hit an upload fault. Deadlines keep being
  enforced across backoff: a request that expires while backing off is
  shed, not dispatched.
* **shard failover, deadline-checked** — an engine that raises
  ``ShardFailedError`` *after* updating its serving view is re-entered
  on the engine rung, deadlines re-checked at that failover instant.
  An engine with ``join_batch_covered`` (the sharded engines, which the
  port does not have yet: ROADMAP Queue A5) serves the degraded-
  coverage rung with its sound per-query recall lower bounds; the
  scheduler finds it by ``hasattr``, as the JAX package's does.

The scheduler is step-driven and clock-injectable: ``step()`` forms and
executes one batch, ``drain()`` runs until idle, ``serve_forever()``
spawns the single consumer thread a live deployment uses (it runs on
the engine's device and on the CUDA stream current where it was
started). ``submit`` is thread-safe. ``run_open_loop`` drives the same
scheduler under a ``VirtualClock`` — Poisson / bursty arrivals in
virtual time, *measured* wall time per executed batch — and
``LoadReport`` gives p50/p99/p999 latency, goodput, shed rate and
degraded fraction at an offered load (``chip_smoke.py`` phase 17).

On the card the double-buffered dispatch overlaps only if ``dispatch``
returns before the device finishes: the engines upload each batch from
a pinned host buffer with a non-blocking copy
(``core.megastep.MegastepEngine.enqueue``), so ``dispatch`` makes no
host sync.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .. import obs
from ..core.types import JoinStats
from . import faultinject

__all__ = [
    "Arrival", "LoadReport", "Priority", "SchedulerConfig",
    "SchedulerStats", "ServeScheduler", "Ticket", "VirtualClock",
    "bursty_times", "poisson_times", "run_open_loop",
]


class Priority(enum.IntEnum):
    """Lanes, dispatched in ascending order; bulk sheds first."""

    INTERACTIVE = 0        # latency-sensitive decode traffic
    BULK = 1               # backfill / batch re-scoring


# process-wide request ids: the flight recorder's correlation key
# (``repro_torch.obs.explain(ticket)`` reconstructs one request's span tree
# by matching these against span ``ticket``/``tickets`` attributes)
_TICKET_IDS = itertools.count(1)


def _join_attrs(js: JoinStats) -> dict:
    """The paper's §6 metrics (plus serving-state fields) as span
    attributes — host-side ints/floats only, attached after the engine
    call returned (so nothing here ever forces a device fetch)."""
    out = dict(tiles_total=js.tiles_total, tiles_visited=js.tiles_visited,
               tiles_pruned=js.tiles_total - js.tiles_visited,
               selectivity=js.selectivity, replicas=js.replicas_s,
               pivot_pairs=js.pivot_pairs_computed,
               n_segments=js.n_segments, n_tombstones=js.n_tombstones)
    if js.n_shards:
        out.update(n_shards=js.n_shards,
                   n_failed_shards=js.n_failed_shards,
                   coverage_bound=js.coverage_bound)
    if js.quant_mode:
        out.update(quant_mode=js.quant_mode, quant_mp=js.quant_mp,
                   n_quant_fallback=js.n_quant_fallback)
    if js.n_degraded:
        out.update(n_degraded=js.n_degraded,
                   recall_bound=js.recall_bound)
    return out


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Admission, coalescing and degradation knobs.

    The watermarks form the degradation ladder: backlog ≤
    ``degrade_queued_rows`` serves exact; above it, batches run the
    certified-approximate path (when a quantized engine exists); above
    ``shed_queued_rows``, queued bulk is shed; above
    ``max_queued_rows``, admission itself rejects.
    """

    batch_rows: int = 256            # coalescing target per dispatch
    max_queued_rows: int = 4096      # admission bound (all lanes)
    default_deadline_s: float = 1.0  # used when submit passes none
    degrade_queued_rows: int = 1024  # ladder rung 1: go coarse-only
    shed_queued_rows: int = 2048     # ladder rung 2: shed bulk
    max_retries: int = 3             # transient-fault retries per batch
    backoff_base_s: float = 0.02     # capped exponential backoff
    backoff_cap_s: float = 0.5
    # double-buffered dispatch: >1 keeps that many megasteps in flight
    # (dispatch batch N+1 before fetching batch N's results, overlapping
    # host-side batch formation with device compute). 1 = synchronous
    # step semantics (dispatch + fetch inside one step). Needs an engine
    # with the async ``dispatch``/``finalize`` split — the scheduler
    # silently stays synchronous otherwise. Deadlines are re-checked at
    # the dispatch instant either way: n_expired_dispatched stays 0.
    max_inflight: int = 1

    def __post_init__(self):
        if self.batch_rows < 1:
            raise ValueError("batch_rows must be >= 1")
        if self.max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if not (self.degrade_queued_rows <= self.shed_queued_rows
                <= self.max_queued_rows):
            raise ValueError(
                "degradation ladder out of order: need degrade_queued_rows"
                " <= shed_queued_rows <= max_queued_rows, got "
                f"{self.degrade_queued_rows} / {self.shed_queued_rows} / "
                f"{self.max_queued_rows}")
        if self.max_retries < 0 or self.backoff_base_s < 0:
            raise ValueError("max_retries/backoff_base_s must be >= 0")


@dataclasses.dataclass
class Ticket:
    """One submitted request and (eventually) its outcome.

    ``status``: ``queued`` → ``done`` | ``shed`` | ``rejected`` |
    ``failed``. ``reason`` explains non-``done`` outcomes (``deadline``,
    ``queue_full``, ``overload``, ``fault``). A ``done`` ticket carries
    ``distances``/``indices`` (the engine contract: true distances
    ascending, int64 global ids) and ``recall_bound`` — per-query
    certified recall lower bounds, all-ones on the exact path,
    the ε-certificate bound when ``degraded``.
    """

    rows: np.ndarray = dataclasses.field(repr=False)
    n: int = 0
    ticket_id: int = 0
    priority: Priority = Priority.INTERACTIVE
    arrival: float = 0.0
    deadline: float = 0.0
    status: str = "queued"
    reason: str = ""
    degraded: bool = False
    attempts: int = 0
    dispatched_at: Optional[float] = None
    completed_at: Optional[float] = None
    distances: Optional[np.ndarray] = None
    indices: Optional[np.ndarray] = None
    recall_bound: Optional[np.ndarray] = None

    @property
    def done(self) -> bool:
        return self.status == "done"


@dataclasses.dataclass
class SchedulerStats:
    """Serving-runtime counters (requests unless suffixed ``_rows``).

    ``n_expired_dispatched`` is the hard invariant: the number of
    requests whose deadline had already passed at the moment they were
    handed to an engine. The scheduler sheds expired requests at batch
    formation *and* re-checks across retry backoff, so this must stay
    0.

    Concurrency: the background ``serve_forever()`` worker mutates
    these fields (and folds per-attempt ``JoinStats`` into ``join``)
    under the scheduler's lock — read through
    :meth:`ServeScheduler.snapshot` from any other thread; a bare
    ``sched.stats`` read races the worker.
    """

    n_submitted: int = 0
    n_completed: int = 0
    n_rejected: int = 0
    n_shed_deadline: int = 0
    n_shed_overload: int = 0
    n_failed: int = 0
    n_degraded_requests: int = 0
    n_dispatches: int = 0
    n_retries: int = 0
    n_expired_dispatched: int = 0
    # batches re-entered after a ShardFailedError (the engine failed
    # over its serving view; the retry ran on the updated view)
    n_failovers: int = 0
    rows_submitted: int = 0
    rows_completed: int = 0
    rows_shed: int = 0
    join: JoinStats = dataclasses.field(default_factory=JoinStats)

    @property
    def n_shed(self) -> int:
        return self.n_shed_deadline + self.n_shed_overload


class ServeScheduler:
    """Admission control + deadlines + degradation in front of one
    engine. See the module docstring for the policy; see
    :meth:`for_datastore` for the serving wiring.

    ``engine`` is anything with ``join_batch(q, stats=)`` — normally a
    ``core.StreamJoinEngine``. ``degraded_engine="auto"`` picks up the
    engine's quantized megastep (``join_batch_approx``) when present;
    pass ``None`` to disable the certified-approximate rung (overload
    then goes straight to shedding). ``host_join`` is the retry target
    for transient faults — defaults to the engine's host-planned oracle
    path. ``clock``/``sleep`` are injectable for deterministic tests
    and the virtual-time bench.

    Concurrency contract: ``submit`` may be called from any thread;
    ``step``/``drain`` must run on a single consumer thread (use
    :meth:`serve_forever` for the background-worker form).
    """

    def __init__(self, engine, *, degraded_engine: object = "auto",
                 host_join: Optional[Callable] = None,
                 config: Optional[SchedulerConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.engine = engine
        me = getattr(engine, "megastep_engine", None)
        if degraded_engine == "auto":
            degraded_engine = me if hasattr(me, "join_batch_approx") \
                else None
        self.degraded_engine = degraded_engine
        # the degraded-coverage rung: a sharded engine that certifies
        # per-query recall bounds once shard loss uncovers pivot groups
        self._coverage_engine = me if hasattr(me, "join_batch_covered") \
            else None
        if host_join is None:
            host_join = getattr(engine, "join_batch_host", None) \
                or engine.join_batch
        self._host_join = host_join
        self.config = config or SchedulerConfig()
        self._clock = clock
        self._sleep = sleep
        self.stats = SchedulerStats()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._lanes = {p: [] for p in Priority}
        self._queued_rows = 0
        self._worker: Optional[threading.Thread] = None
        self._stop = False
        # double-buffered dispatch (config.max_inflight > 1): batches
        # handed to the engine's async dispatch() whose results have not
        # been fetched yet, oldest first. Only the consumer thread
        # touches this deque.
        self._inflight: deque = deque()
        self._pipelined = (self.config.max_inflight > 1
                           and bool(getattr(engine, "can_dispatch", False)))

    @classmethod
    def for_datastore(cls, store, k: Optional[int] = None, **kw
                      ) -> "ServeScheduler":
        """Scheduler over a ``serve.Datastore``'s resident engine: the
        exact path is whatever the store serves (quantized-certified or
        fp32 megastep), the degraded rung is the store's quantized
        engine when it has one, and fault retries land on the
        host-planned oracle over the same mutable index."""
        return cls(store.engine(k), **kw)

    # ---- admission --------------------------------------------------

    def submit(self, queries: np.ndarray, *,
               deadline_s: Optional[float] = None,
               priority: Priority = Priority.INTERACTIVE,
               arrival: Optional[float] = None) -> Ticket:
        """Admit one request (a block of query rows). Returns its
        ``Ticket`` immediately — ``rejected`` (queue full) is decided
        here; everything else resolves when a later ``step`` processes
        it. ``arrival`` backdates the request (open-loop drivers stamp
        the true arrival time so queueing during a busy step still
        counts against latency and the deadline)."""
        q = np.ascontiguousarray(queries, np.float32)
        if q.ndim != 2 or q.shape[0] == 0:
            raise ValueError(f"submit wants (n>0, dim) rows, got {q.shape}")
        now = self._clock()
        arr = now if arrival is None else float(arrival)
        dls = self.config.default_deadline_s if deadline_s is None \
            else float(deadline_s)
        t = Ticket(rows=q, n=q.shape[0], ticket_id=next(_TICKET_IDS),
                   priority=priority, arrival=arr, deadline=arr + dls)
        n_evicted = 0
        with self._lock:
            self.stats.n_submitted += 1
            self.stats.rows_submitted += t.n
            cap = self.config.max_queued_rows
            if self._queued_rows + t.n > cap \
                    and priority == Priority.INTERACTIVE:
                # interactive may evict queued bulk (newest first): the
                # lowest-priority work is shed to make room, explicitly
                bulk = self._lanes[Priority.BULK]
                while bulk and self._queued_rows + t.n > cap:
                    victim = bulk.pop()
                    self._mark_shed_locked(victim, "overload")
                    self._drop_rows_locked(victim.n)
                    n_evicted += 1
            if self._queued_rows + t.n > cap:
                t.status, t.reason = "rejected", "queue_full"
                self.stats.n_rejected += 1
                self.stats.rows_shed += t.n
                reg = obs.metrics.REGISTRY
                reg.counter("serve_submitted_total").inc()
                reg.counter("serve_rejected_total").inc()
                obs.event("serve.admission", ticket=t.ticket_id, rows=t.n,
                          priority=int(priority), outcome="rejected")
                return t
            self._lanes[priority].append(t)
            self._queued_rows += t.n
            queued = self._queued_rows
            self._work.notify()
        reg = obs.metrics.REGISTRY
        reg.counter("serve_submitted_total").inc()
        reg.gauge("serve_queued_rows").set(queued)
        obs.event("serve.admission", ticket=t.ticket_id, rows=t.n,
                  priority=int(priority), outcome="admitted",
                  evicted_bulk=n_evicted, queued_rows=queued)
        return t

    def snapshot(self) -> SchedulerStats:
        """Consistent copy of :attr:`stats` taken under the scheduler
        lock — the race-free read for benches, guards and dashboards
        while ``serve_forever()`` mutates the originals. The returned
        object (including its ``join``) is detached: mutating it never
        touches the live counters, and the live counters never mutate
        it."""
        with self._lock:
            return dataclasses.replace(
                self.stats, join=dataclasses.replace(self.stats.join))

    @property
    def queued_rows(self) -> int:
        return self._queued_rows

    @property
    def has_work(self) -> bool:
        return self._queued_rows > 0 or bool(self._inflight)

    @property
    def inflight_batches(self) -> int:
        """Dispatched-but-unfetched megasteps (0 on the sync path)."""
        return len(self._inflight)

    # ---- batch formation (lock held) --------------------------------

    def _mark_shed_locked(self, t: Ticket, reason: str) -> None:
        t.status, t.reason = "shed", reason
        t.completed_at = self._clock()
        if reason == "deadline":
            self.stats.n_shed_deadline += 1
        else:
            self.stats.n_shed_overload += 1
        self.stats.rows_shed += t.n
        obs.metrics.REGISTRY.counter("serve_shed_total",
                                     reason=reason).inc()
        obs.event("serve.shed", ticket=t.ticket_id, reason=reason)

    def _drop_rows_locked(self, n: int) -> None:
        self._queued_rows -= n

    def _form_batch_locked(self, now: float) -> List[Ticket]:
        cfg = self.config
        # 1. deadline sheds — expired requests leave the queue here,
        # before any of them could reach a device
        for lane in self._lanes.values():
            kept = []
            for t in lane:
                if t.deadline < now:
                    self._mark_shed_locked(t, "deadline")
                    self._drop_rows_locked(t.n)
                else:
                    kept.append(t)
            lane[:] = kept
        # 2. overload sheds — past the shed watermark, bulk goes first
        # (newest first: oldest queued bulk keeps its place in line)
        bulk = self._lanes[Priority.BULK]
        while self._queued_rows > cfg.shed_queued_rows and bulk:
            victim = bulk.pop()
            self._mark_shed_locked(victim, "overload")
            self._drop_rows_locked(victim.n)
        # 3. coalesce — fill one batch, interactive first, FIFO per lane
        batch: List[Ticket] = []
        rows = 0
        for p in Priority:
            lane = self._lanes[p]
            while lane and (rows == 0 or rows + lane[0].n <= cfg.batch_rows):
                t = lane.pop(0)
                self._drop_rows_locked(t.n)
                batch.append(t)
                rows += t.n
            if rows >= cfg.batch_rows:
                break
        return batch

    # ---- execution --------------------------------------------------

    def step(self) -> int:
        """Form one coalesced batch and execute it (with degradation
        and fault retries). Returns the number of query rows processed
        (completed, shed, or — in double-buffered mode — dispatched);
        0 when there was nothing to do.

        With ``max_inflight > 1`` and a dispatch-capable engine, the
        batch is *dispatched* (device work starts) and the oldest
        previously dispatched batch is fetched only once the in-flight
        window is full — batch N's device pass overlaps batch N+1's
        formation + dispatch. An empty queue drains the window.
        """
        now = self._clock()
        with self._lock:
            pressure = self._queued_rows
            batch = self._form_batch_locked(now)
        if batch and obs.enabled():
            obs.event("serve.coalesce",
                      tickets=tuple(t.ticket_id for t in batch),
                      rows=sum(t.n for t in batch),
                      queued_rows=pressure)
        obs.metrics.REGISTRY.gauge("serve_queued_rows") \
            .set(self._queued_rows)
        degraded = (self.degraded_engine is not None
                    and pressure > self.config.degrade_queued_rows)
        # degraded coverage (shard loss with no live replica) routes
        # through the blocking covered call so responses carry the
        # engine's certified recall bounds — skip the pipelined path,
        # whose finalize drops them
        covered = (self._coverage_engine is not None
                   and self._coverage_engine.coverage_degraded)
        if self._pipelined and not degraded and not covered:
            n = self._dispatch_pipelined(batch) if batch else 0
            # keep up to max_inflight-1 megasteps in flight across
            # steps while new work keeps arriving; drain when idle
            keep = (self.config.max_inflight - 1) if batch else 0
            while len(self._inflight) > keep:
                n += self._finalize_oldest()
            return n
        # sync path (or the degraded rung, which is a blocking engine
        # call): flush any in-flight work first so results stay FIFO
        n = 0
        while self._inflight:
            n += self._finalize_oldest()
        if not batch:
            return n
        self._execute(batch, degraded)
        return n + sum(t.n for t in batch)

    def drain(self) -> None:
        """Step until no queued work remains (tests / shutdown flush)."""
        while self.step():
            pass

    def join_now(self, queries: np.ndarray, **kw) -> Ticket:
        """Submit + pump until this request resolves — the synchronous
        convenience the kNN-LM decode hook uses. Requests queued ahead
        are served first (FIFO is preserved)."""
        t = self.submit(queries, **kw)
        while t.status == "queued":
            self.step()
        return t

    # ---- double-buffered dispatch (consumer thread only) ------------

    def _dispatch_pipelined(self, batch: List[Ticket]) -> int:
        """Hand one coalesced batch to the engine's async ``dispatch``
        and park the handle in the in-flight window. Deadlines are
        re-checked at the dispatch instant (the clock may have advanced
        since batch formation), so the n_expired_dispatched == 0
        invariant holds on this path exactly as on the sync one. A
        dispatch fault falls back to the synchronous retry ladder
        (host-planned oracle) for this batch alone."""
        now = self._clock()
        live, dead = [], []
        for t in batch:
            (live if t.deadline >= now else dead).append(t)
        if dead:
            with self._lock:
                for t in dead:
                    self._mark_shed_locked(t, "deadline")
        if not live:
            return sum(t.n for t in dead)
        q = live[0].rows if len(live) == 1 else \
            np.concatenate([t.rows for t in live], axis=0)
        dispatch_at = self._clock()
        n_exp = sum(1 for t in live if t.deadline < dispatch_at)
        with self._lock:
            self.stats.n_dispatches += 1
            self.stats.n_expired_dispatched += n_exp
        reg = obs.metrics.REGISTRY
        reg.counter("serve_dispatch_total").inc()
        if n_exp:
            reg.counter("serve_expired_dispatched_total").inc(n_exp)
        for t in live:
            t.dispatched_at = dispatch_at
            t.attempts += 1
        # per-batch JoinStats: engine stamps land here and are *merged*
        # into the aggregate (JoinStats.merged) instead of overwriting a
        # shared object from a worker thread
        js = JoinStats()
        tks = tuple(t.ticket_id for t in live) if obs.enabled() else ()
        try:
            with obs.span("serve.attempt", tickets=tks, attempt=0,
                          rung="engine", pipelined=True) as sp:
                try:
                    faultinject.fire("sched.dispatch")
                    handle = self.engine.dispatch(q, stats=js)
                except faultinject.ShardFailedError as e:
                    sp.set(outcome="shard_failed", shard=e.shard)
                    raise
                sp.set(outcome="dispatched", **_join_attrs(js))
        except faultinject.ShardFailedError as e:
            # the engine failed over its serving view: re-enter the
            # engine rung (not the host oracle) — _execute re-checks
            # deadlines at this failover instant before dispatching
            with self._lock:
                self.stats.n_failovers += 1
                self.stats.join = self.stats.join.merged(js)
            reg.counter("serve_failovers_total").inc()
            obs.event("serve.failover", tickets=tks, shard=e.shard)
            self._execute(live, False)
            return sum(t.n for t in batch)
        except Exception:    # noqa: BLE001 — transient-fault ladder
            with self._lock:
                self.stats.join = self.stats.join.merged(js)
            self._execute(live, False, first_attempt=1)
            return sum(t.n for t in batch)
        with self._lock:
            self.stats.join = self.stats.join.merged(js)
        self._inflight.append((handle, live))
        return sum(t.n for t in batch)

    def _finalize_oldest(self) -> int:
        """Fetch + complete the oldest in-flight batch. A finalize
        fault (failed fetch, poisoned result) re-runs the batch's
        tickets through the synchronous retry ladder."""
        handle, live = self._inflight.popleft()
        js = JoinStats()
        tks = tuple(t.ticket_id for t in live) if obs.enabled() else ()
        try:
            with obs.span("serve.finalize", tickets=tks) as sp:
                try:
                    d, i = self.engine.finalize(handle, stats=js)
                except faultinject.ShardFailedError as e:
                    sp.set(outcome="shard_failed", shard=e.shard)
                    raise
                sp.set(outcome="done", **_join_attrs(js))
        except faultinject.ShardFailedError as e:
            # failover: re-run on the engine's updated serving view,
            # deadlines re-checked at the failover instant
            with self._lock:
                self.stats.n_failovers += 1
                self.stats.join = self.stats.join.merged(js)
            obs.metrics.REGISTRY.counter("serve_failovers_total").inc()
            obs.event("serve.failover", tickets=tks, shard=e.shard)
            self._execute(live, False)
            return sum(t.n for t in live)
        except Exception:    # noqa: BLE001 — transient-fault ladder
            with self._lock:
                self.stats.join = self.stats.join.merged(js)
            self._execute(live, False, first_attempt=1)
            return sum(t.n for t in live)
        with self._lock:
            self.stats.join = self.stats.join.merged(js)
        self._complete(live, d, i, None)
        return sum(t.n for t in live)

    # ---- synchronous execution with retries -------------------------

    def _complete(self, live: List[Ticket], d, i, rb) -> None:
        done_at = self._clock()
        lo = 0
        with self._lock:
            for t in live:
                t.distances = d[lo:lo + t.n]
                t.indices = i[lo:lo + t.n]
                t.recall_bound = (rb[lo:lo + t.n] if rb is not None
                                  else np.ones(t.n, np.float32))
                t.degraded = rb is not None
                t.status = "done"
                t.completed_at = done_at
                lo += t.n
                self.stats.n_completed += 1
                self.stats.rows_completed += t.n
                if t.degraded:
                    self.stats.n_degraded_requests += 1
        reg = obs.metrics.REGISTRY
        lat = reg.histogram("serve_latency_s")
        reg.counter("serve_completed_total").inc(len(live))
        if rb is not None:
            reg.counter("serve_degraded_total").inc(len(live))
        for t in live:
            lat.observe(max(0.0, done_at - t.arrival))
        if obs.enabled():
            obs.event("serve.complete",
                      tickets=tuple(t.ticket_id for t in live),
                      rows=sum(t.n for t in live),
                      degraded=rb is not None)

    def _execute(self, batch: List[Ticket], degraded: bool, *,
                 first_attempt: int = 0) -> None:
        """Blocking execute with the capped-backoff retry ladder.
        ``first_attempt > 0`` enters the ladder at that rung — the
        double-buffered path uses it to route a batch whose async
        dispatch/finalize faulted straight onto the host-planned oracle
        (its rung-0 engine call is what just failed), with the retry
        budget reduced accordingly."""
        cfg = self.config
        live = list(batch)

        def attempt_fn(attempt: int):
            nonlocal live, degraded
            attempt += first_attempt
            now = self._clock()
            still, dead = [], []
            for t in live:
                (still if t.deadline >= now else dead).append(t)
            # re-check at the attempt instant — the one place this event
            # is emitted, so a traced request shows exactly one
            # deadline_recheck per (re)attempt of the synchronous ladder
            obs.event("serve.deadline_recheck",
                      tickets=tuple(t.ticket_id for t in live)
                      if obs.enabled() else (),
                      attempt=attempt, shed=len(dead))
            if dead:
                # expired mid-backoff: shed now — never dispatched
                with self._lock:
                    for t in dead:
                        self._mark_shed_locked(t, "deadline")
                live = still
            if not live:
                return None
            q = live[0].rows if len(live) == 1 else \
                np.concatenate([t.rows for t in live], axis=0)
            dispatch_at = self._clock()
            n_exp = sum(1 for t in live if t.deadline < dispatch_at)
            with self._lock:
                self.stats.n_dispatches += 1
                self.stats.n_expired_dispatched += n_exp
                if attempt > 0:
                    self.stats.n_retries += 1
            reg = obs.metrics.REGISTRY
            reg.counter("serve_dispatch_total").inc()
            if n_exp:
                reg.counter("serve_expired_dispatched_total").inc(n_exp)
            if attempt > 0:
                reg.counter("serve_retries_total").inc()
            for t in live:
                t.dispatched_at = dispatch_at
                t.attempts += 1
            # per-attempt JoinStats, merged into the aggregate on every
            # exit path — retried/failed-over attempts no longer
            # overwrite each other's engine stamps
            js = JoinStats()
            rung = ("degraded" if attempt == 0 and degraded else
                    "covered" if attempt == 0
                    and self._coverage_engine is not None else
                    "engine" if attempt == 0 else "host")
            tks = tuple(t.ticket_id for t in live) if obs.enabled() \
                else ()
            try:
                with obs.span("serve.attempt", tickets=tks,
                              attempt=attempt, rung=rung) as sp:
                    faultinject.fire("sched.dispatch")
                    if attempt == 0:
                        if degraded:
                            d, i, rb = \
                                self.degraded_engine.join_batch_approx(
                                    q, stats=js)
                            sp.set(outcome="ok", **_join_attrs(js))
                            return d, i, rb
                        ce = self._coverage_engine
                        if ce is not None:
                            # engine rung via the covered call:
                            # surviving shards answer and each response
                            # carries a certified per-query recall lower
                            # bound. The bound is kept only when the
                            # batch actually ran on a degraded-coverage
                            # view — a mid-call failover past the last
                            # replica flips ``coverage_degraded``, and
                            # the engine's internal retry already
                            # computed the batch (and its bound) on that
                            # updated view.
                            d, i, rb = ce.join_batch_covered(q, stats=js)
                            sp.set(outcome="ok", **_join_attrs(js))
                            if ce.coverage_degraded:
                                return d, i, rb
                            return d, i, None
                        d, i = self.engine.join_batch(q, stats=js)
                        sp.set(outcome="ok", **_join_attrs(js))
                        return d, i, None
                    # retry rung: the host-planned oracle — exact, no
                    # resident device payload to re-fault on
                    degraded = False
                    d, i = self._host_join(q, stats=js)
                    sp.set(outcome="ok", **_join_attrs(js))
                    return d, i, None
            finally:
                with self._lock:
                    self.stats.join = self.stats.join.merged(js)

        try:
            out = faultinject.retry_with_backoff(
                attempt_fn,
                max_retries=max(0, cfg.max_retries - first_attempt),
                base_s=cfg.backoff_base_s, cap_s=cfg.backoff_cap_s,
                sleep=self._sleep)
        except Exception as e:   # noqa: BLE001 — overload robustness:
            # a poisoned batch must not take the scheduler down
            with self._lock:
                for t in live:
                    t.status, t.reason = "failed", f"fault: {e!r}"
                    t.completed_at = self._clock()
                    self.stats.n_failed += 1
            obs.metrics.REGISTRY.counter("serve_failed_total") \
                .inc(len(live))
            if obs.enabled():
                obs.event("serve.failed",
                          tickets=tuple(t.ticket_id for t in live),
                          error=type(e).__name__)
            return
        if out is None:
            return                      # everything expired pre-dispatch
        d, i, rb = out
        self._complete(live, d, i, rb)

    # ---- background worker ------------------------------------------

    def serve_forever(self) -> threading.Thread:
        """Spawn the single consumer thread: steps whenever work is
        queued, sleeps on the condition variable otherwise. Idempotent;
        ``shutdown()`` stops it. A CUDA engine's work runs on the
        engine's device and on the stream current in the calling thread
        (a new thread would otherwise start on device 0's default
        stream)."""
        if self._worker is not None and self._worker.is_alive():
            return self._worker
        self._stop = False
        dev = _engine_device(self.engine)
        stream = torch.cuda.current_stream(dev) \
            if dev is not None and dev.type == "cuda" else None

        def loop():
            if stream is not None:
                with torch.cuda.device(dev), torch.cuda.stream(stream):
                    consume()
            else:
                consume()

        def consume():
            while True:
                with self._work:
                    # _inflight is consumer-thread-only state: reading
                    # it here (the consumer) needs no extra locking
                    while not self._queued_rows and not self._inflight \
                            and not self._stop:
                        self._work.wait(timeout=0.1)
                    if self._stop:
                        return
                self.step()

        self._worker = threading.Thread(target=loop, daemon=True,
                                        name="serve-scheduler")
        self._worker.start()
        return self._worker

    def shutdown(self, *, drain: bool = True) -> None:
        """Stop the worker; by default flush remaining work first."""
        if self._worker is None:
            if drain:
                self.drain()
            return
        if drain:
            while self.has_work and self._worker.is_alive():
                time.sleep(0.005)
        with self._work:
            self._stop = True
            self._work.notify_all()
        self._worker.join(timeout=5.0)
        self._worker = None


def _engine_device(engine) -> Optional[torch.device]:
    """The device an engine's work runs on (None when it names none)."""
    for obj in (getattr(engine, "megastep_engine", None),
                getattr(engine, "index", None), engine):
        dev = getattr(obj, "device", None)
        if isinstance(dev, torch.device):
            return dev
    return None


# ---------------------------------------------------------------------------
# open-loop load harness: virtual clock, arrival processes, reporting


class VirtualClock:
    """Deterministic clock for the open-loop bench and tests: arrivals
    happen in virtual time, executed batches advance it by their real
    measured cost. Pass ``clock=vc.now, sleep=vc.advance`` to the
    scheduler so deadlines and backoff live in the same timeline."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError("time only moves forward")
        self._t += dt


def poisson_times(rate_per_s: float, duration_s: float,
                  rng: np.random.Generator) -> np.ndarray:
    """Arrival instants of a Poisson process on [0, duration)."""
    if rate_per_s <= 0:
        return np.zeros((0,), np.float64)
    n_max = int(rate_per_s * duration_s * 3 + 16)
    gaps = rng.exponential(1.0 / rate_per_s, n_max)
    t = np.cumsum(gaps)
    return t[t < duration_s]


def bursty_times(rate_per_s: float, duration_s: float,
                 rng: np.random.Generator, *, burst: int = 8
                 ) -> np.ndarray:
    """Bursty arrivals at the same average rate: bursts of ``burst``
    back-to-back requests at Poisson epochs of rate ``rate/burst`` —
    the adversarial arrival pattern for queue watermarks."""
    epochs = poisson_times(rate_per_s / burst, duration_s, rng)
    return np.repeat(epochs, burst)


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One open-loop arrival: request rows landing at virtual time t."""

    t: float
    rows: np.ndarray
    priority: Priority = Priority.INTERACTIVE
    deadline_s: Optional[float] = None


def run_open_loop(sched: ServeScheduler, arrivals: Sequence[Arrival],
                  clock: VirtualClock, *,
                  measure: Callable[[], float] = time.perf_counter
                  ) -> List[Ticket]:
    """Drive ``sched`` open-loop: requests arrive at their own pace
    (offered load does not slow down because the server is busy — the
    regime a million-user deployment is judged on), service costs are
    the real measured wall time of each executed batch. Returns every
    ticket, resolved."""
    arrivals = sorted(arrivals, key=lambda a: a.t)
    tickets: List[Ticket] = []
    i = 0
    while i < len(arrivals) or sched.has_work:
        now = clock.now()
        while i < len(arrivals) and arrivals[i].t <= now:
            a = arrivals[i]
            i += 1
            tickets.append(sched.submit(
                a.rows, deadline_s=a.deadline_s, priority=a.priority,
                arrival=a.t))
        if not sched.has_work:
            if i < len(arrivals):
                clock.advance(arrivals[i].t - clock.now())
            continue
        t0 = measure()
        sched.step()
        clock.advance(measure() - t0)
    return tickets


@dataclasses.dataclass
class LoadReport:
    """Aggregates one open-loop run: latency percentiles, goodput (rows
    completed within their deadline per second), shed and degraded
    shares, the ``n_expired_dispatched`` invariant and the smallest
    certified recall bound served."""

    n_requests: int
    n_completed: int
    n_shed: int
    n_rejected: int
    n_failed: int
    n_degraded: int
    rows_total: int
    rows_goodput: int
    duration_s: float
    goodput_rows_s: float
    p50_s: float
    p99_s: float
    p999_s: float
    shed_rate: float
    degraded_frac: float
    n_expired_dispatched: int
    recall_bound_min: float

    @classmethod
    def from_tickets(cls, tickets: Sequence[Ticket],
                     stats: SchedulerStats) -> "LoadReport":
        done = [t for t in tickets if t.done]
        lat = np.sort(np.asarray(
            [t.completed_at - t.arrival for t in done], np.float64))

        def pct(p: float) -> float:
            if lat.size == 0:
                return float("inf")
            return float(lat[min(lat.size - 1, int(p * lat.size))])

        t_end = max((t.completed_at for t in tickets
                     if t.completed_at is not None), default=0.0)
        t0 = min((t.arrival for t in tickets), default=0.0)
        dur = max(t_end - t0, 1e-9)
        good = sum(t.n for t in done if t.completed_at <= t.deadline)
        rows_total = sum(t.n for t in tickets)
        shed = [t for t in tickets if t.status == "shed"]
        rej = [t for t in tickets if t.status == "rejected"]
        degraded = [t for t in done if t.degraded]
        rb_min = min((float(t.recall_bound.min()) for t in degraded),
                     default=1.0)
        return cls(
            n_requests=len(tickets), n_completed=len(done),
            n_shed=len(shed), n_rejected=len(rej),
            n_failed=sum(t.status == "failed" for t in tickets),
            n_degraded=len(degraded),
            rows_total=rows_total, rows_goodput=good,
            duration_s=dur, goodput_rows_s=good / dur,
            p50_s=pct(0.50), p99_s=pct(0.99), p999_s=pct(0.999),
            shed_rate=(sum(t.n for t in shed) + sum(t.n for t in rej))
            / max(rows_total, 1),
            degraded_frac=sum(t.n for t in degraded)
            / max(sum(t.n for t in done), 1),
            n_expired_dispatched=stats.n_expired_dispatched,
            recall_bound_min=rb_min)
