"""The port's group executor and elastic regrouping
(``repro_torch.distributed.fault``) against the JAX package's.

``GroupExecutor`` is host code: both packages' executors run the same
group functions and must schedule them alike (retries, permanent
failure, speculation, attempt timeouts). ``regroup`` works on a query
plan: the port's, and the JAX one applied to the same plan's arrays,
must give the same groups and the same Theorem-6 bounds exactly (a min
over the same float32 values); the regrouped plan still joins exactly
(distances bit for bit the float64 oracle's).
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch as rt  # noqa: E402
from repro_torch.distributed import fault as tfault  # noqa: E402


def _executors():
    from repro.distributed import fault as jfault
    return {"jax": jfault.GroupExecutor, "port": tfault.GroupExecutor}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_retry_on_transient_failure(pkg):
    fails = {3: 2, 5: 1}
    lock = threading.Lock()

    def group_fn(g):
        with lock:
            if fails.get(g, 0) > 0:
                fails[g] -= 1
                raise RuntimeError(f"injected failure in group {g}")
        return g * 10

    ex = _executors()[pkg](max_retries=3, speculate=False, max_workers=2)
    runs = ex.run(group_fn, list(range(8)))
    assert all(r.done for r in runs.values())
    assert [runs[g].result for g in range(8)] == [g * 10 for g in range(8)]
    assert runs[3].attempts == 3 and runs[5].attempts == 2


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_permanent_failure_raises_with_attempt_counts(pkg):
    def group_fn(g):
        if g == 2:
            raise RuntimeError("dead node")
        return g

    ex = _executors()[pkg](max_retries=1, speculate=False, max_workers=2)
    with pytest.raises(RuntimeError, match="group 2 failed after 2"):
        ex.run(group_fn, list(range(4)))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_speculative_execution_on_straggler(pkg):
    slow_started = threading.Event()

    def group_fn(g):
        if g == 0 and not slow_started.is_set():
            slow_started.set()
            time.sleep(1.5)
        return g

    ex = _executors()[pkg](max_retries=2, speculate=True,
                           speculate_after=0.5, max_workers=4)
    t0 = time.monotonic()
    runs = ex.run(group_fn, list(range(6)))
    assert all(r.done for r in runs.values()) and runs[0].speculated
    assert time.monotonic() - t0 < 1.4


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_attempt_timeout_reissues_hung_group(pkg):
    hung_once = threading.Event()
    release = threading.Event()

    def group_fn(g):
        if g == 1 and not hung_once.is_set():
            hung_once.set()
            release.wait(10.0)
        return g

    ex = _executors()[pkg](max_retries=2, speculate=False, max_workers=4,
                           attempt_timeout=0.3)
    try:
        runs = ex.run(group_fn, list(range(4)))
    finally:
        release.set()
    assert all(r.done for r in runs.values())
    assert runs[1].attempts == 2 and runs[1].result == 1


def test_run_with_retries_same_counts():
    counts = {}
    for pkg, cls in _executors().items():
        left = {1: 2}

        def group_fn(g):
            if left.get(g, 0):
                left[g] -= 1
                raise RuntimeError("transient")
            return -g

        runs = cls(max_retries=2).run_with_retries(group_fn, [0, 1, 2])
        counts[pkg] = {g: (r.attempts, r.result) for g, r in runs.items()}
    assert counts["jax"] == counts["port"]


def _plans(seed, n_groups):
    """The port's plan and the JAX package's QueryPlan over its arrays."""
    from repro.core.index import QueryPlan as JPlan
    from repro.core.types import JoinConfig as JConfig
    from repro.core.types import SummaryTable as JTable
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(250, 5)).astype(np.float32)
    s = rng.normal(size=(400, 5)).astype(np.float32)
    plan = rt.core.plan_join(r, s, rt.JoinConfig(k=5, n_pivots=20,
                                                 n_groups=n_groups),
                             device="cpu")
    q = plan.query
    jq = JPlan(config=JConfig(k=5, n_pivots=20, n_groups=n_groups),
               r_part=q.r_part.numpy(), r_dist=q.r_dist.numpy(),
               t_r=JTable(counts=q.t_r.counts.numpy(),
                          lower=q.t_r.lower.numpy(),
                          upper=q.t_r.upper.numpy()),
               theta=q.theta.numpy(), lb=q.lb.numpy(),
               groups=q.groups.numpy(), lb_group=q.lb_group.numpy())
    return r, s, plan, jq


@pytest.mark.parametrize("n_groups,new_n", [(6, 2), (6, 3), (4, 8),
                                             (4, 12), (4, 4)])
def test_regroup_matches_jax_and_stays_exact(n_groups, new_n):
    from repro.distributed.fault import regroup as jregroup
    r, s, plan, jq = _plans(n_groups, n_groups)
    got = tfault.regroup(plan, new_n)
    want = jregroup(jq, new_n)
    if new_n == n_groups:
        assert got is plan
    assert np.array_equal(got.query.groups.numpy(), want.groups)
    assert np.array_equal(got.query.lb_group.numpy(), want.lb_group)
    assert got.query.n_groups == want.lb_group.shape[1]
    res = rt.knn_join(r, plan=got, device="cpu")
    bd, _ = rt.brute_force_knn(r, s, 5, device="cpu")
    assert np.array_equal(res.distances, bd)
    # a bare QueryPlan regroups the same way
    q = tfault.regroup(plan.query, new_n)
    assert torch.equal(q.groups, got.query.groups)
