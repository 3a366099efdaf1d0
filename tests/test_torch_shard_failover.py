"""Shard fault tolerance in the port (``core.sharded`` +
``serve.faultinject`` + ``serve.scheduler``) — the counterparts of the
JAX package's ``tests/test_shard_failover.py``: replicated pivot-group
placement, failover with the same bits, certified degraded coverage,
bounded attempt timeouts and recovery.

The JAX package runs its multi-shard cases in subprocesses with 8 forced
host devices; the port runs them in-process on 8 shards simulated from
an explicit CPU device list. Tolerances: failover and recovery give the
healthy engine's bits exactly; every certified recall bound is at most
the true recall against the float64 brute force.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch as rt  # noqa: E402
from repro_torch.core import StreamJoinEngine  # noqa: E402
from repro_torch.core.sharded import (ShardedMegastepEngine,  # noqa: E402
                                      ShardHealth)
from repro_torch.distributed import make_mesh  # noqa: E402
from repro_torch.serve.faultinject import (FaultPlan,  # noqa: E402
                                           InjectedFault, ShardFailedError,
                                           ShardFault)
from repro_torch.serve.scheduler import (SchedulerConfig,  # noqa: E402
                                         ServeScheduler, VirtualClock)

DIM = 6


def _mesh(n):
    return make_mesh((n,), ("shard",), devices=["cpu"] * n)


def _data(n=400, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, DIM)).astype(np.float32) * 2).copy()


def _index(n=400, k=5):
    cfg = rt.JoinConfig(k=k, n_pivots=24, n_groups=6, grouping="geometric",
                        tile_r=16, tile_s=32)
    return rt.build_index(_data(n), cfg, device="cpu"), cfg


def _engine(n_shards=1, **kw):
    idx, cfg = _index()
    return ShardedMegastepEngine(idx, cfg, mesh=_mesh(n_shards), **kw), idx


def _fault(site, shard):
    return ShardFault(site, shard=shard)


# ------------------------------------------------ replicated packing

def test_replicated_packing_invariants():
    idx, _ = _index()
    for n_sh, r in ((2, 2), (4, 2), (4, 3), (8, 4), (2, 5)):
        sp = idx.shard_packing(n_sh, r=r)
        r_eff = min(r, n_sh)
        assert sp.r == r_eff
        reps = sp.replicas_of_part
        assert reps.shape == (r_eff, idx.n_pivots)
        assert np.array_equal(reps[0], sp.shard_of_part)
        assert ((reps >= 0) & (reps < n_sh)).all()
        for p in range(idx.n_pivots):
            assert len(set(reps[:, p].tolist())) == r_eff
        assert int(sp.rows_per_shard.sum()) == r_eff * idx.n_s
        for j in range(n_sh):
            live = sp.gids_local[j] >= 0
            order = np.lexsort((sp.dist[j][live], sp.part[j][live]))
            assert np.array_equal(order, np.arange(order.size))


def test_owner_view_partitions_served_rows_exactly_once():
    idx, _ = _index()
    sp = idx.shard_packing(4, r=2)
    part_sorted = idx.s_part_sorted.numpy()
    ids_sorted = idx.s_ids_sorted.numpy()
    for failed in ((), (1,), (0, 2), (3, 1), (0, 1, 2)):
        owner = sp.owner_view(frozenset(failed))
        assert not set(np.unique(owner)) & set(failed)
        served = np.sort(sp.gids_local[sp.serve_mask(owner)])
        covered = ~np.isin(part_sorted, np.where(owner < 0)[0])
        assert np.array_equal(served, np.sort(ids_sorted[covered]))
        frac = sp.coverage_fraction(owner)
        assert frac == pytest.approx(covered.sum() / idx.n_s)
        assert sp.uncovered_parts(owner).any() == (frac < 1.0)
    assert np.array_equal(sp.owner_view(()), sp.shard_of_part)


def test_owner_view_prefers_primary_then_first_live_backup():
    idx, _ = _index()
    sp = idx.shard_packing(4, r=3)
    reps = sp.replicas_of_part
    owner = sp.owner_view(frozenset({int(reps[0, 0])}))
    assert owner[0] == reps[1, 0]
    alive = reps[0] != reps[0, 0]
    assert np.array_equal(owner[alive], reps[0][alive])


def test_partition_counts_deduplicate_replicas():
    idx, _ = _index()
    for r in (1, 2, 3):
        np.testing.assert_array_equal(
            idx.shard_packing(4, r=r).partition_counts(),
            np.bincount(idx.s_part.numpy(), minlength=idx.n_pivots))


def test_replication_validation_and_hbm_cost():
    idx, _ = _index()
    with pytest.raises(ValueError, match="replication factor"):
        idx.shard_packing(4, r=0)
    per1 = idx.shard_packing(4, r=1).nbytes_per_shard()
    per2 = idx.shard_packing(4, r=2).nbytes_per_shard()
    assert int(per1.sum()) == idx.nbytes_resident()
    assert int(per2.sum()) == 2 * idx.nbytes_resident()


# ------------------------------------------------------- health tracker

def test_shard_health_semantics():
    h = ShardHealth(4)
    assert h.failed == frozenset() and h.generation == 0
    assert h.mark_failed(2)
    assert h.failed == frozenset({2}) and h.generation == 1
    assert not h.mark_failed(2)
    assert not h.mark_failed(7)
    assert not h.mark_failed(None)
    assert h.generation == 1 and h.n_faults == 4
    h.note_timeout()
    assert h.n_timeouts == 1
    h.reset()
    assert h.failed == frozenset() and h.generation == 2


# ---------------------------------------- 1-shard failover wiring

def test_shard_fault_marks_health_and_fails_over():
    """A ShardFault at the compute site marks the shard and raises
    ShardFailedError; join_batch_covered retries on the new view (one
    shard, r = 1: nothing left — empty results, rb = 0, coverage 0);
    recovery restores the healthy bits."""
    eng, _ = _engine()
    q = _data(30, seed=3)
    d0, i0 = eng.join_batch(q)
    with FaultPlan().fail("sharded.shard_compute", times=1, exc=_fault(
            "sharded.shard_compute", 0)) as plan:
        d, i, rb = eng.join_batch_covered(q)
    assert plan.fired["sharded.shard_compute"] == 2
    assert eng.health.failed == frozenset({0})
    assert eng.coverage_degraded and eng.coverage_fraction() == 0.0
    assert np.isinf(d).all() and (i == -1).all() and (rb == 0.0).all()
    eng.recover(wait=True)
    assert not eng.health.failed and not eng.coverage_degraded
    d2, i2 = eng.join_batch(q)
    np.testing.assert_array_equal(d0, d2)
    np.testing.assert_array_equal(i0, i2)


def test_shard_failed_error_exhausts_after_bounded_retries():
    eng, _ = _engine()
    exc = _fault("sharded.shard_compute", 0)
    with FaultPlan().fail("sharded.shard_compute", times=99, exc=exc):
        with pytest.raises(ShardFailedError):
            eng.join_batch(_data(10, seed=4))


def test_anonymous_fault_on_shard_site_stays_generic():
    eng, _ = _engine()
    with FaultPlan().fail("sharded.shard_compute", times=1):
        with pytest.raises(InjectedFault):
            eng.dispatch(_data(8, seed=5))
    assert eng.health.failed == frozenset()
    assert eng.health.n_faults == 0


def test_poisoned_collective_fails_over():
    eng, _ = _engine()
    h = eng.dispatch(_data(8, seed=6))
    with FaultPlan().fail("sharded.collective", times=1, exc=_fault(
            "sharded.collective", 0)):
        with pytest.raises(ShardFailedError):
            eng.finalize(h)
    assert eng.health.failed == frozenset({0})


# ------------------------------------- fault-plan composition

def test_mixed_site_plan_fires_each_site_as_armed():
    idx, cfg = _index()
    eng = StreamJoinEngine(idx, cfg, megastep=True, mesh=_mesh(1),
                           device="cpu")
    sched = ServeScheduler(eng, config=SchedulerConfig(max_inflight=1),
                           sleep=lambda _s: None)
    me = eng.megastep_engine
    q = _data(12, seed=7)
    ref_d, ref_i = eng.join_batch_host(q)
    plan = (FaultPlan()
            .fail("sharded.shard_compute", times=1,
                  exc=_fault("sharded.shard_compute", 0))
            .fail("megastep.fetch", times=1)
            .fail("sched.dispatch", times=1)
            .transform("sharded.collective", lambda v: v))
    with plan:
        with pytest.raises(InjectedFault):
            me.join_batch(q)
        assert me.health.failed == frozenset({0})
        d, i, rb = me.join_batch_covered(q)
        assert (rb == 0.0).all()
        t = sched.join_now(q)
    assert t.done and not t.degraded
    np.testing.assert_array_equal(t.distances, ref_d)
    np.testing.assert_array_equal(t.indices, ref_i)
    assert plan.fired["sharded.shard_compute"] >= 2
    assert plan.fired["megastep.fetch"] >= 2
    assert plan.fired["sched.dispatch"] >= 2
    assert plan.fired["sharded.collective"] >= 1


def test_upload_site_fires_during_payload_build():
    eng, _ = _engine()
    with FaultPlan().transform("quant.eps_inflation", lambda v: v) as plan:
        eng.join_batch(_data(8, seed=8))
    assert plan.fired.get("sharded.shard_upload", 0) >= 1


def test_failover_reuploads_masks_only():
    """Failover is a mask swap: after a shard loss the next refresh
    uploads each shard's alive mask and its present masks, never rows."""
    eng, _ = _engine(4, replication=2)
    q = _data(20, seed=17)
    eng.join_batch(q)
    with FaultPlan().fail("sharded.shard_compute", times=1, exc=_fault(
            "sharded.shard_compute", 1)) as plan:
        eng.join_batch(q)
    assert plan.fired["sharded.shard_upload"] == 4 * (1 + 1)


# --------------------------------- scheduler: failover + deadlines

def _sharded_sched(mi=2, **cfg_kw):
    idx, cfg = _index()
    eng = StreamJoinEngine(idx, cfg, megastep=True, mesh=_mesh(1),
                           device="cpu")
    vc = VirtualClock()
    sched = ServeScheduler(
        eng, config=SchedulerConfig(max_inflight=mi, backoff_base_s=0.05,
                                    **cfg_kw),
        clock=vc.now, sleep=vc.advance)
    return sched, eng, vc, cfg


def test_scheduler_failover_serves_degraded_with_bounds():
    sched, eng, vc, cfg = _sharded_sched()
    q = _data(9, seed=9)
    with FaultPlan().fail("sharded.shard_compute", times=1, exc=_fault(
            "sharded.shard_compute", 0)):
        t = sched.join_now(q)
    assert t.done and t.degraded
    assert (t.recall_bound == 0.0).all()
    assert sched.stats.n_failovers == 1
    assert sched.stats.n_expired_dispatched == 0
    assert sched.stats.join.n_failed_shards == 1
    assert sched.stats.join.coverage_bound == 0.0
    eng.megastep_engine.recover(wait=True)
    t2 = sched.join_now(q)
    assert t2.done and not t2.degraded


def test_deadline_rechecked_at_failover_instant():
    sched, eng, vc, cfg = _sharded_sched()

    def hang_then_die(v):
        vc.advance(10.0)        # the failure burns the whole deadline
        raise ShardFault("sharded.collective", shard=0)

    with FaultPlan().transform("sharded.collective", hang_then_die):
        t = sched.submit(_data(7, seed=10), deadline_s=1.0)
        sched.drain()
    assert t.status == "shed" and t.reason == "deadline"
    assert sched.stats.n_failovers == 1
    assert sched.stats.n_expired_dispatched == 0
    assert eng.megastep_engine.health.failed == frozenset({0})


def test_sync_path_failover_matches_pipelined():
    sched, eng, vc, cfg = _sharded_sched(mi=1)
    with FaultPlan().fail("sharded.shard_compute", times=1, exc=_fault(
            "sharded.shard_compute", 0)):
        t = sched.join_now(_data(6, seed=11))
    assert t.done and t.degraded
    assert sched.stats.n_expired_dispatched == 0


# -------------------------------------- bounded attempt timeouts

def test_attempt_timeout_converts_hang_to_failover():
    eng, _ = _engine(attempt_timeout=0.25)
    q = _data(20, seed=12)
    d0, i0 = eng.join_batch(q)
    hung_once = threading.Event()
    release = threading.Event()

    def hang_first(v):
        if not hung_once.is_set():
            hung_once.set()
            release.wait(30.0)
        return v

    try:
        with FaultPlan().transform("sharded.collective", hang_first):
            d, i = eng.join_batch(q)
    finally:
        release.set()
    assert eng.health.n_timeouts == 1
    assert eng.health.failed == frozenset()
    np.testing.assert_array_equal(d, d0)
    np.testing.assert_array_equal(i, i0)


def test_attempt_timeout_none_keeps_blocking_semantics():
    eng, _ = _engine()
    assert eng.attempt_timeout is None
    eng.join_batch(_data(8, seed=13))
    assert eng._attempt_pool is None


# ----------------------------------------------- wiring / validation

def test_stream_engine_replication_plumbing():
    idx, cfg = _index()
    eng = StreamJoinEngine(idx, cfg, megastep=True, mesh=_mesh(1),
                           replication=2, device="cpu")
    assert eng.megastep_engine.replication == 1      # clamped at n_shards
    with pytest.raises(ValueError, match="sharded-engine knobs"):
        StreamJoinEngine(idx, cfg, megastep=True, replication=2,
                         device="cpu")
    qcfg = rt.JoinConfig(k=5, n_pivots=24, n_groups=6, quantize="int8")
    qidx = rt.build_index(_data(), qcfg, device="cpu")
    with pytest.raises(ValueError, match="does not replicate"):
        StreamJoinEngine(qidx, qcfg, quantized=True, mesh=_mesh(1),
                         replication=2, device="cpu")
    with pytest.raises(ValueError, match="replication must be >= 1"):
        ShardedMegastepEngine(idx, cfg, mesh=_mesh(1), replication=0)


def test_datastore_replication_and_recover_shards():
    from repro_torch.serve import Datastore
    keys = _data(300, seed=14)
    store = Datastore.build(keys, np.arange(300) % 17, k=4, n_pivots=16,
                            n_shards=1, replication=2, mesh=_mesh(1),
                            device="cpu")
    d0, i0, v0 = store.retrieve(_data(6, seed=15))
    me = store.engine().megastep_engine
    assert me.replication == 1
    with FaultPlan().fail("sharded.shard_compute", times=1, exc=_fault(
            "sharded.shard_compute", 0)):
        store.retrieve(_data(6, seed=15))
    assert me.health.failed == frozenset({0})
    assert store.recover_shards(wait=True) == [] and not me.health.failed
    d1, i1, v1 = store.retrieve(_data(6, seed=15))
    np.testing.assert_array_equal(d0, d1)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(v0, v1)


def test_stats_stamp_failed_shards_and_count_rows_once():
    """n_r counts a failed-over batch once (the JAX package counts every
    attempt, ROADMAP C4)."""
    eng, _ = _engine()
    stats = rt.JoinStats()
    eng.join_batch(_data(8, seed=16), stats=stats)
    assert (stats.n_shards, stats.n_failed_shards, stats.n_r) == (1, 0, 8)
    assert stats.coverage_bound == 1.0 and stats.recall_bound == 1.0
    eng4, _ = _engine(4, replication=2)
    stats = rt.JoinStats()
    with FaultPlan().fail("sharded.shard_compute", times=1, exc=_fault(
            "sharded.shard_compute", 2)):
        eng4.join_batch(_data(8, seed=16), stats=stats)
    assert stats.n_r == 8 and stats.n_failed_shards == 1


# ----------------------------------------------- 8 simulated shards

def _clustered(n, seed, centers=None):
    rng = np.random.default_rng(seed)
    if centers is None:
        centers = np.random.default_rng(99).normal(
            size=(40, 8)).astype(np.float32) * 20.0
    asg = rng.integers(0, centers.shape[0], n)
    return (centers[asg] + 0.5 * rng.normal(size=(n, 8))).astype(
        np.float32), centers


@pytest.fixture(scope="module")
def clustered():
    s, cents = _clustered(4000, 0)
    q, _ = _clustered(250, 1, cents)
    cfg = rt.JoinConfig(k=8, n_pivots=64, n_groups=6,
                        pivot_strategy="kmeans")
    idx = rt.build_index(s, cfg, device="cpu")
    d0, i0 = rt.MegastepEngine(idx, cfg, device="cpu").join_batch(q)
    return s, q, cfg, idx, d0, i0


def test_r2_failover_bitwise(clustered):
    s, q, cfg, idx, d0, i0 = clustered
    eng = ShardedMegastepEngine(idx, cfg, mesh=_mesh(8), replication=2)
    d1, i1 = eng.join_batch(q)
    assert np.array_equal(d0, d1) and np.array_equal(i0, i1)
    with FaultPlan().fail("sharded.shard_compute", times=1, exc=_fault(
            "sharded.shard_compute", 3)):
        d2, i2 = eng.join_batch(q)
    assert np.array_equal(d0, d2) and np.array_equal(i0, i2)
    assert sorted(eng.health.failed) == [3]
    assert not eng.coverage_degraded
    t = eng.recover(wait=False)
    t.join(timeout=120)
    assert not eng.health.failed
    d3, i3 = eng.join_batch(q)
    assert np.array_equal(d0, d3) and np.array_equal(i0, i3)


def test_r1_recall_bound_sound(clustered):
    s, q, cfg, idx, d0, i0 = clustered
    eng = ShardedMegastepEngine(idx, cfg, mesh=_mesh(8), replication=1)
    with FaultPlan().fail("sharded.shard_compute", times=1, exc=_fault(
            "sharded.shard_compute", 2)):
        d, i, rb = eng.join_batch_covered(q)
    k = cfg.k
    q64, s64 = q.astype(np.float64), s.astype(np.float64)
    dd = ((q64[:, None, :] - s64[None, :, :]) ** 2).sum(-1)
    true_ids = np.argsort(dd, axis=1, kind="stable")[:, :k]
    recall = np.array([len(set(i[j].tolist()) & set(true_ids[j].tolist()))
                       / k for j in range(q.shape[0])])
    assert eng.coverage_degraded and eng.coverage_fraction() < 1.0
    assert (recall >= rb).all(), "a certified bound exceeds the true recall"
    # on clustered rows the certificate is not vacuous
    assert (rb == 1.0).mean() > 0.5 and rb.max() == 1.0
