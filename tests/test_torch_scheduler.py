"""The serving scheduler, port vs JAX package: admission control,
deadlines, priority lanes, coalescing, the degradation ladder,
fault-injected retries and the double-buffered dispatch — the cases of
the JAX package's ``tests/test_scheduler.py`` and
``tests/test_scheduler_pipeline.py`` on the port's engines, on the CPU.

Every scheduler here runs on a ``VirtualClock``: deadlines and backoff
live in virtual time and service costs come from an injected
``measure``, so no case depends on how fast the host is (the JAX
package's pipeline case sheds tickets while JAX compiles: ROADMAP C2).
Then one trace through both packages' schedulers with the same arrivals
and the same fixed service costs, and the certified-approximate rung
(``join_batch_approx``) against the JAX package's on one index."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro_torch as rt  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    Arrival, FaultPlan, InjectedFault, LoadReport, Priority,
    SchedulerConfig, ServeScheduler, VirtualClock, bursty_times,
    faultinject, poisson_times, run_open_loop)

from torch_parity import assert_same_join, data, index_arrays  # noqa: E402

DIM = 12


def _data(n=600, seed=0):
    return np.random.default_rng(seed).normal(size=(n, DIM)).astype(
        np.float32)


def _engine(n=600, *, quantized=False, k=4, seed=0, megastep="auto"):
    s = _data(n, seed)
    cfg = rt.JoinConfig(k=k, n_pivots=32, n_groups=4,
                        quantize="int8" if quantized else "none")
    idx = rt.build_index(s, cfg, device="cpu")
    return rt.StreamJoinEngine(idx, cfg, megastep=megastep,
                               quantized=quantized, device="cpu"), s, cfg


def _sched(eng, vc=None, **kw):
    """A scheduler on virtual time (``sleep`` advances it, unless given)."""
    vc = vc or VirtualClock()
    kw.setdefault("sleep", vc.advance)
    return ServeScheduler(eng, clock=vc.now, **kw)


def _ref(q, s, cfg):
    return rt.knn_join(q, s, k=cfg.k, config=cfg, device="cpu")


def _assert_exact(t, q, s, cfg):
    ref = _ref(q, s, cfg)
    np.testing.assert_array_equal(t.distances, ref.distances)
    np.testing.assert_array_equal(t.indices, ref.indices)


# ---------------------------------------------------------------------------
# tests/test_scheduler.py, on the port's engines


def test_exact_path_bitwise_oracle():
    """A scheduled request's result is the engine's own output verbatim
    — admission and coalescing perturb no bit."""
    eng, s, cfg = _engine()
    sched = _sched(eng)
    q = _data(10, seed=1)
    t = sched.join_now(q)
    assert t.done and not t.degraded
    _assert_exact(t, q, s, cfg)
    np.testing.assert_array_equal(t.recall_bound, np.ones(10, np.float32))


def test_coalescing_splits_back_per_request():
    eng, s, cfg = _engine()
    sched = _sched(eng, config=SchedulerConfig(batch_rows=64))
    qs = [_data(n, seed=10 + n) for n in (3, 17, 8, 5)]
    tickets = [sched.submit(q) for q in qs]
    assert sched.queued_rows == 33
    assert sched.step() == 33
    assert sched.stats.n_dispatches == 1         # one coalesced batch
    for q, t in zip(qs, tickets):
        assert t.done
        _assert_exact(t, q, s, cfg)


def test_batch_rows_caps_coalescing():
    eng, _, _ = _engine()
    sched = _sched(eng, config=SchedulerConfig(batch_rows=16))
    for _ in range(4):
        sched.submit(_data(10, seed=3))
    sched.drain()
    assert sched.stats.n_dispatches == 4


def test_expired_requests_shed_before_dispatch():
    eng, _, _ = _engine()
    vc = VirtualClock()
    sched = _sched(eng, vc)
    t_live = sched.submit(_data(4, seed=4), deadline_s=10.0)
    t_dead = sched.submit(_data(4, seed=5), deadline_s=0.5)
    vc.advance(1.0)                    # t_dead expires in the queue
    sched.drain()
    assert t_live.done
    assert t_dead.status == "shed" and t_dead.reason == "deadline"
    assert t_dead.dispatched_at is None
    assert sched.stats.n_shed_deadline == 1
    assert sched.stats.n_expired_dispatched == 0


def test_priority_lanes_interactive_first():
    eng, _, _ = _engine()
    sched = _sched(eng, config=SchedulerConfig(batch_rows=8))
    t_bulk = sched.submit(_data(8, seed=6), priority=Priority.BULK)
    t_int = sched.submit(_data(8, seed=7), priority=Priority.INTERACTIVE)
    sched.step()
    assert t_int.done and t_bulk.status == "queued"
    sched.step()
    assert t_bulk.done


def test_admission_bound_rejects_and_interactive_evicts_bulk():
    eng, _, _ = _engine()
    cfg = SchedulerConfig(batch_rows=8, max_queued_rows=16,
                          degrade_queued_rows=16, shed_queued_rows=16)
    sched = _sched(eng, config=cfg)
    t1 = sched.submit(_data(10, seed=8), priority=Priority.BULK)
    t2 = sched.submit(_data(10, seed=9), priority=Priority.BULK)
    assert t2.status == "rejected" and t2.reason == "queue_full"
    t3 = sched.submit(_data(12, seed=10), priority=Priority.INTERACTIVE)
    assert t3.status == "queued"
    assert t1.status == "shed" and t1.reason == "overload"
    sched.drain()
    assert t3.done
    assert sched.stats.n_rejected == 1 and sched.stats.n_shed_overload == 1
    assert sched.queued_rows == 0


def test_overload_sheds_bulk_at_watermark():
    eng, _, _ = _engine()
    cfg = SchedulerConfig(batch_rows=8, max_queued_rows=64,
                          degrade_queued_rows=8, shed_queued_rows=24)
    sched = _sched(eng, config=cfg)
    bulk = [sched.submit(_data(8, seed=20 + i), priority=Priority.BULK)
            for i in range(4)]
    t_int = sched.submit(_data(8, seed=30))
    sched.drain()
    assert t_int.done
    assert [b.status for b in bulk] == ["done", "done", "shed", "shed"]
    assert all(b.reason == "overload" for b in bulk if b.status == "shed")


def _true_recall(t, q, s, cfg):
    ref = _ref(q, s, cfg)
    return np.asarray([len(set(ref.indices[i].tolist())
                           & {x for x in t.indices[i].tolist() if x >= 0})
                       / cfg.k for i in range(q.shape[0])])


def test_degraded_mode_certified_recall_bounds():
    """Above the degrade watermark the quantized engine serves
    coarse-only: degraded responses with a *valid* certified recall
    bound, checked against the true top-k."""
    eng, s, cfg = _engine(quantized=True)
    sched = _sched(eng, config=SchedulerConfig(batch_rows=32,
                                               degrade_queued_rows=0))
    assert sched.degraded_engine is not None
    qs = [_data(8, seed=40 + i) for i in range(3)]
    tickets = [sched.submit(q) for q in qs]
    sched.drain()
    for q, t in zip(qs, tickets):
        assert t.done and t.degraded
        rb = t.recall_bound
        assert rb.shape == (8,) and (rb >= 0).all() and (rb <= 1).all()
        assert (_true_recall(t, q, s, cfg) >= rb - 1e-6).all()
        # degraded distances are still exact per reported neighbour
        np.testing.assert_allclose(
            t.distances, np.asarray(
                [[np.linalg.norm(q[i] - s[j]) if j >= 0 else np.inf
                  for j in t.indices[i]] for i in range(q.shape[0])]),
            rtol=1e-5, atol=1e-5)
    assert sched.stats.n_degraded_requests == 3
    assert sched.stats.join.n_degraded == 24
    assert sched.stats.join.recall_bound <= 1.0


def test_no_degraded_engine_serves_exact_under_pressure():
    eng, _, _ = _engine()
    sched = _sched(eng, config=SchedulerConfig(batch_rows=32,
                                               degrade_queued_rows=0))
    assert sched.degraded_engine is None
    t = sched.join_now(_data(5, seed=50))
    assert t.done and not t.degraded


def test_transient_fault_retried_onto_host_path():
    eng, s, cfg = _engine()
    slept = []
    sched = _sched(eng, config=SchedulerConfig(
        backoff_base_s=0.01, backoff_cap_s=0.04, max_retries=3),
        sleep=slept.append)
    q = _data(6, seed=60)
    with FaultPlan().fail("sched.dispatch", times=2) as plan:
        t = sched.join_now(q)
    assert t.done and t.attempts == 3
    assert plan.fired["sched.dispatch"] == 3
    assert sched.stats.n_retries == 2
    assert slept == [0.01, 0.02]              # capped exponential backoff
    _assert_exact(t, q, s, cfg)


def test_payload_upload_fault_recovered():
    eng, s, cfg = _engine()
    eng.megastep_engine._payload = None       # force a rebuild
    sched = _sched(eng, sleep=lambda _s: None)
    q = _data(6, seed=61)
    with FaultPlan().fail("megastep.payload_upload", times=1) as plan:
        t = sched.join_now(q)
    assert t.done and plan.fired["megastep.payload_upload"] == 1
    _assert_exact(t, q, s, cfg)


def test_fetch_fault_recovered():
    eng, s, cfg = _engine()
    sched = _sched(eng, sleep=lambda _s: None)
    q = _data(6, seed=62)
    with FaultPlan().fail("megastep.fetch", times=1):
        t = sched.join_now(q)
    assert t.done and t.attempts == 2
    _assert_exact(t, q, s, cfg)


def test_permanent_fault_marks_failed_not_hung():
    eng, _, _ = _engine()
    sched = _sched(eng, config=SchedulerConfig(max_retries=2),
                   sleep=lambda _s: None)
    t = sched.submit(_data(4, seed=63))
    with FaultPlan().fail("sched.dispatch", times=99,
                          exc=RuntimeError("wedged device")):
        sched.drain()
    assert t.status == "failed" and "wedged device" in t.reason
    assert sched.stats.n_failed == 1 and sched.queued_rows == 0


def test_deadline_enforced_across_backoff():
    eng, _, _ = _engine()
    sched = _sched(eng, config=SchedulerConfig(backoff_base_s=1.0,
                                               backoff_cap_s=1.0))
    t = sched.submit(_data(4, seed=64), deadline_s=0.5)
    with FaultPlan().fail("sched.dispatch", times=1):
        sched.drain()
    assert t.status == "shed" and t.reason == "deadline"
    assert t.attempts == 1
    assert sched.stats.n_expired_dispatched == 0


def test_submit_thread_safe_under_concurrent_consumer():
    """Producers on four threads, the consumer on ``serve_forever``'s;
    virtual time stands still, so no deadline can pass."""
    eng, _, _ = _engine()
    sched = _sched(eng, config=SchedulerConfig(batch_rows=64))
    tickets, lock = [], threading.Lock()

    def producer(seed):
        for i in range(5):
            t = sched.submit(_data(7, seed=seed * 100 + i))
            with lock:
                tickets.append(t)

    sched.serve_forever()
    try:
        threads = [threading.Thread(target=producer, args=(s,))
                   for s in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        t0 = time.monotonic()
        while sched.has_work and time.monotonic() - t0 < 50.0:
            time.sleep(0.01)
    finally:
        sched.shutdown()
    assert len(tickets) == 20 and all(t.done for t in tickets)
    assert sched.stats.rows_completed == 140


def _fixed_cost(dt=0.004):
    """``measure`` for ``run_open_loop``: every step costs ``dt``."""
    fake = iter(np.arange(1, 1_000_000) * dt)
    return lambda: next(fake)


def _overload_arrivals(rng, n_rows=8, seed0=200):
    times = bursty_times(2000.0, 0.5, rng, burst=4)
    return [Arrival(t=float(t), rows=_data(n_rows, seed=seed0 + j),
                    priority=(Priority.BULK if j % 3 == 0
                              else Priority.INTERACTIVE))
            for j, t in enumerate(times)]


OVERLOAD = dict(batch_rows=32, degrade_queued_rows=64, shed_queued_rows=96,
                max_queued_rows=128, default_deadline_s=0.05)


def test_open_loop_overload_smoke():
    eng, _, _ = _engine(n=400, quantized=True)
    vc = VirtualClock()
    sched = _sched(eng, vc, config=SchedulerConfig(**OVERLOAD))
    arrivals = _overload_arrivals(np.random.default_rng(5))
    tickets = run_open_loop(sched, arrivals, vc, measure=_fixed_cost())
    rep = LoadReport.from_tickets(tickets, sched.stats)
    assert rep.n_requests == len(arrivals)
    assert (rep.n_completed + rep.n_shed + rep.n_rejected + rep.n_failed
            == rep.n_requests)
    assert rep.n_completed > 0 and rep.goodput_rows_s > 0
    assert rep.n_shed + rep.n_rejected > 0          # overload engaged
    assert rep.n_expired_dispatched == 0            # the hard invariant
    assert np.isfinite(rep.p50_s) and rep.p50_s <= rep.p99_s <= rep.p999_s
    for t in tickets:
        if t.done and t.degraded:
            assert 0.0 <= float(t.recall_bound.min()) <= 1.0
    assert 0.0 <= rep.recall_bound_min <= 1.0


def test_arrival_generators():
    rng = np.random.default_rng(0)
    p = poisson_times(100.0, 2.0, rng)
    assert p.size > 0 and (np.diff(p) >= 0).all() and p[-1] < 2.0
    assert abs(p.size - 200) < 3 * np.sqrt(200)
    b = bursty_times(100.0, 2.0, rng, burst=8)
    assert b.size % 8 == 0 and (np.diff(b) >= 0).all()
    assert poisson_times(0.0, 2.0, rng).size == 0


def test_scheduler_config_validation():
    for bad in (dict(batch_rows=0),
                dict(degrade_queued_rows=100, shed_queued_rows=50),
                dict(shed_queued_rows=5000, max_queued_rows=4096),
                dict(max_retries=-1)):
        with pytest.raises(ValueError):
            SchedulerConfig(**bad)
    eng, _, _ = _engine(n=100)
    with pytest.raises(ValueError):
        _sched(eng).submit(np.zeros((0, DIM), np.float32))


def test_fault_plan_arming():
    with pytest.raises(InjectedFault):
        with FaultPlan().fail("x", times=1):
            faultinject.fire("x")
    faultinject.fire("x")                      # outside: sites are dead
    with FaultPlan():
        with pytest.raises(RuntimeError):
            with FaultPlan():                  # double-arm rejected
                pass


def test_knn_logits_through_scheduler():
    """Same logits as the direct route when unloaded; a rejected batch
    degrades to the log floor."""
    from repro_torch.serve import Datastore, KnnLMConfig, knn_logits

    rng = np.random.default_rng(9)
    keys = rng.normal(size=(400, DIM)).astype(np.float32)
    vals = rng.integers(0, 32, 400).astype(np.int32)
    store = Datastore.build(keys, vals, k=4, n_pivots=32, n_groups=4,
                            device="cpu")
    kcfg = KnnLMConfig(k=4)
    q = rng.normal(size=(5, DIM)).astype(np.float32)
    direct = knn_logits(q, store, kcfg, vocab=32)
    vc = VirtualClock()
    sched = ServeScheduler.for_datastore(store, clock=vc.now)
    via = knn_logits(q, store, kcfg, vocab=32, scheduler=sched)
    np.testing.assert_array_equal(direct, via)
    full = ServeScheduler.for_datastore(
        store, config=SchedulerConfig(max_queued_rows=2,
                                      degrade_queued_rows=1,
                                      shed_queued_rows=2), clock=vc.now)
    lg, (d, i) = knn_logits(q, store, kcfg, vocab=32, scheduler=full,
                            return_neighbors=True)
    np.testing.assert_allclose(lg, np.log(1e-9))
    assert (i == -1).all() and np.isinf(d).all()


# ---------------------------------------------------------------------------
# tests/test_scheduler_pipeline.py, on the port's engines


@pytest.mark.parametrize("quantized", [False, True])
def test_pipelined_bitwise_matches_sync(quantized):
    """max_inflight = 1 and 2 give every ticket the same bits."""
    eng, s, cfg = _engine(quantized=quantized)
    qs = [_data(n, seed=70 + n) for n in (9, 4, 13, 7, 11)]
    outs = []
    for mi in (1, 2):
        sched = _sched(eng, config=SchedulerConfig(batch_rows=16,
                                                   max_inflight=mi))
        tickets = [sched.submit(q) for q in qs]
        sched.drain()
        assert all(t.done and not t.degraded for t in tickets)
        outs.append(tickets)
    for q, t_sync, t_pipe in zip(qs, *outs):
        np.testing.assert_array_equal(t_pipe.distances, t_sync.distances)
        np.testing.assert_array_equal(t_pipe.indices, t_sync.indices)
        _assert_exact(t_pipe, q, s, cfg)


def test_pipelined_coalesces_and_splits_back():
    eng, s, cfg = _engine()
    sched = _sched(eng, config=SchedulerConfig(batch_rows=64,
                                               max_inflight=2))
    qs = [_data(n, seed=80 + n) for n in (3, 17, 8)]
    tickets = [sched.submit(q) for q in qs]
    sched.drain()
    assert sched.stats.n_dispatches == 1
    for q, t in zip(qs, tickets):
        assert t.done
        _assert_exact(t, q, s, cfg)


def test_pipelined_window_overlaps_then_drains():
    eng, _, _ = _engine()
    sched = _sched(eng, config=SchedulerConfig(batch_rows=8,
                                               max_inflight=2))
    tickets = [sched.submit(_data(8, seed=90 + i)) for i in range(3)]
    assert sched.step() == 8                   # dispatch #1, nothing done
    assert sched.inflight_batches == 1
    assert tickets[0].status == "queued" and sched.has_work
    sched.step()                               # dispatch #2, finalize #1
    assert tickets[0].done and tickets[1].status == "queued"
    assert sched.inflight_batches == 1
    sched.step()                               # dispatch #3, finalize #2
    assert tickets[1].done
    assert sched.step() == 8                   # queue empty: drain window
    assert tickets[2].done and sched.inflight_batches == 0
    assert not sched.has_work and sched.step() == 0
    assert all(t.attempts == 1 for t in tickets)
    assert sched.stats.n_retries == 0


def test_pipelined_join_now_resolves():
    eng, s, cfg = _engine()
    sched = _sched(eng, config=SchedulerConfig(max_inflight=3))
    q = _data(6, seed=100)
    t = sched.join_now(q)
    assert t.done and sched.inflight_batches == 0
    _assert_exact(t, q, s, cfg)


def test_pipelined_dispatch_fault_falls_back_to_host_ladder():
    eng, s, cfg = _engine()
    sched = _sched(eng, config=SchedulerConfig(max_inflight=2),
                   sleep=lambda _s: None)
    q = _data(6, seed=110)
    with FaultPlan().fail("sched.dispatch", times=1) as plan:
        t = sched.join_now(q)
    assert t.done and t.attempts == 2
    assert plan.fired["sched.dispatch"] == 2
    assert sched.stats.n_retries == 1
    _assert_exact(t, q, s, cfg)
    t2 = sched.join_now(_data(5, seed=111))    # pipeline still healthy
    assert t2.done and t2.attempts == 1


def test_pipelined_finalize_fault_falls_back_to_host_ladder():
    eng, s, cfg = _engine()
    sched = _sched(eng, config=SchedulerConfig(max_inflight=2),
                   sleep=lambda _s: None)
    q = _data(6, seed=120)
    with FaultPlan().fail("megastep.fetch", times=1) as plan:
        t = sched.join_now(q)
    assert t.done and t.attempts == 2
    assert plan.fired["megastep.fetch"] == 1
    _assert_exact(t, q, s, cfg)


def test_pipelined_deadline_rechecked_at_dispatch():
    eng, _, _ = _engine()
    vc = VirtualClock()
    sched = _sched(eng, vc, config=SchedulerConfig(batch_rows=8,
                                                   max_inflight=2))
    t_dead = sched.submit(_data(4, seed=130), deadline_s=0.5)
    vc.advance(1.0)
    sched.drain()
    assert t_dead.status == "shed" and t_dead.reason == "deadline"
    assert t_dead.dispatched_at is None
    t_late = sched.submit(_data(4, seed=131), deadline_s=0.5)
    sched.step()                               # dispatches, stays in flight
    assert t_late.dispatched_at is not None
    vc.advance(1.0)                            # expires while in flight
    sched.drain()
    assert t_late.done
    assert sched.stats.n_expired_dispatched == 0


def test_pipelined_degraded_rung_stays_synchronous():
    eng, _, _ = _engine(quantized=True)
    sched = _sched(eng, config=SchedulerConfig(
        batch_rows=32, degrade_queued_rows=0, max_inflight=2))
    tickets = [sched.submit(_data(8, seed=140 + i)) for i in range(3)]
    sched.drain()
    assert sched.inflight_batches == 0
    for t in tickets:
        assert t.done and t.degraded
        rb = t.recall_bound
        assert rb.shape == (8,) and (rb >= 0).all() and (rb <= 1).all()


def test_host_engine_ignores_max_inflight():
    s = _data(300, seed=1)
    cfg = rt.JoinConfig(k=4, n_pivots=32, n_groups=4)
    eng = rt.StreamJoinEngine(rt.build_index(s, cfg, device="cpu"), cfg,
                              megastep=False, device="cpu")
    assert not eng.can_dispatch
    sched = _sched(eng, config=SchedulerConfig(max_inflight=4))
    q = _data(7, seed=150)
    t = sched.join_now(q)
    assert t.done and sched.inflight_batches == 0
    _assert_exact(t, q, s, cfg)


def test_max_inflight_validation():
    with pytest.raises(ValueError):
        SchedulerConfig(max_inflight=0)


# ---------------------------------------------------------------------------
# the port's own: batches in flight, no host sync in dispatch, the
# coverage rung


def test_dispatch_in_flight_then_finalize_in_order():
    """Four dispatches in flight, then four finalizes in order: each
    batch's bits equal a one-at-a-time join."""
    for quantized in (False, True):
        eng, _, _ = _engine(quantized=quantized)
        qs = [_data(n, seed=160 + n) for n in (5, 16, 9, 16)]
        one = [eng.join_batch(q) for q in qs]
        handles = [eng.dispatch(q) for q in qs]
        for (d1, i1), h in zip(one, handles):
            d, i = eng.finalize(h)
            np.testing.assert_array_equal(d, d1)
            np.testing.assert_array_equal(i, i1)


def test_dispatch_makes_no_host_sync(monkeypatch):
    """``dispatch`` of a warm engine reads nothing back from its tensors
    (the CPU stand-in for ``set_sync_debug_mode("error")``)."""
    for quantized in (False, True):
        eng, _, _ = _engine(quantized=quantized)
        q = _data(16, seed=170)
        warm = eng.finalize(eng.dispatch(q))

        def boom(*a, **k):
            raise AssertionError("host sync inside dispatch")
        with monkeypatch.context() as m:
            for name in ("item", "tolist", "__bool__", "__int__",
                         "__float__", "__index__", "numpy", "nonzero"):
                m.setattr(torch.Tensor, name, boom)
            m.setattr(torch, "nonzero", boom)
            h = eng.dispatch(q)
        d, i = eng.finalize(h)
        np.testing.assert_array_equal(d, warm[0])
        np.testing.assert_array_equal(i, warm[1])


def test_no_coverage_rung_without_a_sharded_engine():
    """The degraded-coverage rung is found by ``hasattr``, as in the JAX
    package; no engine of the port has ``join_batch_covered`` yet."""
    eng, _, _ = _engine(quantized=True)
    assert _sched(eng)._coverage_engine is None


# ---------------------------------------------------------------------------
# against the JAX package


QCFG = dict(k=10, n_pivots=24, tile_r=32, tile_s=64, quantize="int8",
            quant_slack=22, reducer="gather")


def _shared_quant_engines(resident=True):
    """A JAX and a port quantized streaming engine over one index (the
    JAX-built index and its int8 twin carried across)."""
    from repro.core import JoinConfig as JConfig
    from repro.core import StreamJoinEngine as JStream
    from repro.core import build_index as j_build_index
    from repro.quant import QuantMegastepEngine as JQuant

    s, r = data("forest", n_s=2000, n_r=240, seed=11)
    jidx = j_build_index(s, JConfig(**QCFG))
    tidx = rt.sindex_from_arrays(index_arrays(jidx, quant_bn=QCFG["tile_s"]),
                                 rt.JoinConfig(**QCFG), device="cpu")
    jeng = JStream(jidx, JConfig(**QCFG), quantized=True)
    # the scheduled plain version, the one the port's CPU path mirrors
    jeng._megastep = JQuant(jidx, JConfig(**QCFG), impl="ref_sched",
                            resident=resident)
    teng = rt.StreamJoinEngine(tidx, rt.JoinConfig(**QCFG), quantized=True,
                               device="cpu")
    teng.megastep_engine.resident = resident
    teng.megastep_engine._rows_on_device = resident
    return s, r, jeng, teng


def _near_lm(eng, q, s, d):
    """Per query: whether a reported distance lies within twice the
    rounding allowance ε_num of the shortlist bound ``lm`` the port
    certified against — the only place a recall bound may differ from
    the JAX package's (ROADMAP C1). ε_num in distance space is δ /
    max(d, √δ), δ = NUM_DELTA_REL·(‖q̂‖² + ‖ŝ‖²), taken at the largest
    ‖ŝ‖ with a 1 % margin for the quantization."""
    from repro_torch.kernels import quant_topk as kq
    lm = eng.megastep_engine.coarse_shortlist(q)[0][:, -1].astype(np.float64)
    n2 = lambda x: (x.astype(np.float64) ** 2).sum(1)  # noqa: E731
    delta = kq.NUM_DELTA_REL * 1.01 * (n2(q) + n2(s).max())
    tol = 2 * delta / np.maximum(lm, np.sqrt(delta)) + 1e-6
    return (np.abs(d.astype(np.float64) - lm[:, None])
            <= tol[:, None]).any(axis=1)


@pytest.mark.parametrize("resident", [True, False])
def test_join_batch_approx_matches_jax(resident):
    s, r, jeng, teng = _shared_quant_engines(resident)
    js, ts = rt.JoinStats(), rt.JoinStats()
    jd, ji, jrb = jeng.megastep_engine.join_batch_approx(r, stats=js)
    d, i, rb = teng.megastep_engine.join_batch_approx(r, stats=ts)
    assert_same_join(d, i, jd, ji)
    assert (ts.n_degraded, ts.n_resident_rerank, ts.n_host_rerank) == (
        js.n_degraded, js.n_resident_rerank, js.n_host_rerank)
    assert ts.n_quant_fallback == js.n_quant_fallback == 0
    near = _near_lm(teng, r, s, d)
    np.testing.assert_array_equal(rb[~near], jrb[~near])
    assert rb.min() < 1.0                      # the bound is exercised
    # sound against the float64 brute force; Forest-like rows tie, so a
    # reported neighbour is in the true top-k when its distance is at
    # most the true k-th (the same canonical chain on both sides)
    bd, _ = rt.brute_force_knn(r, s, QCFG["k"], device="cpu")
    true = (d <= bd[:, -1:]).sum(axis=1) / QCFG["k"]
    assert (true >= rb).all()
    assert ts.recall_bound == pytest.approx(float(rb.min()))


def test_scheduler_trace_matches_jax():
    """JAX's scheduler and the port's, the same arrivals and the same
    fixed service costs: the same statuses, degraded flags and recall
    bounds (up to the 2·ε_num rule), results within C1."""
    from repro.serve import scheduler as js

    s, r, jeng, teng = _shared_quant_engines()
    cfg_kw = dict(OVERLOAD, batch_rows=24, degrade_queued_rows=32,
                  shed_queued_rows=64, max_queued_rows=96)
    rng = np.random.default_rng(21)
    times = bursty_times(1200.0, 0.1, rng, burst=3)
    rows = [r[(8 * j) % 232:(8 * j) % 232 + 8] for j in range(len(times))]
    traces = []
    for mod, eng in ((js, jeng), (None, teng)):
        if mod is None:
            from repro_torch.serve import scheduler as mod
        vc = mod.VirtualClock()
        sched = mod.ServeScheduler(eng, config=mod.SchedulerConfig(**cfg_kw),
                                   clock=vc.now, sleep=vc.advance)
        arrivals = [mod.Arrival(t=float(t), rows=rows[j], priority=(
            mod.Priority.BULK if j % 3 == 0 else mod.Priority.INTERACTIVE))
            for j, t in enumerate(times)]
        traces.append(mod.run_open_loop(sched, arrivals, vc,
                                        measure=_fixed_cost(0.003)))
    jt, tt = traces
    assert [t.status for t in tt] == [t.status for t in jt]
    assert [t.reason for t in tt] == [t.reason for t in jt]
    assert [t.degraded for t in tt] == [t.degraded for t in jt]
    assert {t.status for t in tt} >= {"done", "shed"}
    assert any(t.degraded for t in tt) and any(
        t.done and not t.degraded for t in tt)
    for a, b in zip(tt, jt):
        assert a.completed_at == b.completed_at
        if not a.done:
            continue
        assert_same_join(a.distances, a.indices, b.distances, b.indices)
        near = _near_lm(teng, a.rows, s, a.distances)
        np.testing.assert_array_equal(a.recall_bound[~near],
                                      b.recall_bound[~near])
