"""Port vs JAX package: the canonical distance chain, the brute-force
oracle, the dataset generator and the observability copy."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import baselines as jbase  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.data.pipeline import forest_like as j_forest_like  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402

# XLA contracts the JAX chain's multiply-adds into FMAs, the port's eager
# chain rounds each op: 1–3 ulp apart was measured (ROADMAP Queue C1)
ULP_BOUND = 4


def _ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("dim", [2, 10, 54, 128])
def test_canonical_gathered_within_4_ulp_of_jax(dim):
    rng = np.random.default_rng(dim)
    q = rng.normal(size=(64, dim)).astype(np.float32) * 30
    neigh = rng.normal(size=(64, 8, dim)).astype(np.float32) * 30
    got = tmetrics.canonical_gathered(torch.from_numpy(q),
                                      torch.from_numpy(neigh)).numpy()
    want = np.asarray(jmetrics.canonical_gathered(q, neigh))
    assert _ulps(got, want).max() <= ULP_BOUND


@pytest.mark.parametrize("metric", ["l2", "l1", "linf"])
def test_cmp_dist_matches_jax(metric):
    """Comparable-space distances; L2 re-centered on the far-off data
    (values near 1000) where the uncentered expansion loses digits."""
    rng = np.random.default_rng(7)
    a = (rng.normal(size=(60, 5)) * 3 + 1000).astype(np.float32)
    b = (rng.normal(size=(80, 5)) * 3 + 1000).astype(np.float32)
    want = jmetrics.cmp_dist(a, b, metric)
    got = tmetrics.cmp_dist(torch.from_numpy(a), torch.from_numpy(b),
                            metric).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_canonical_chain_is_shape_independent():
    """One pair gives the same bits alone and inside a batch."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(97, 10)).astype(np.float32))
    neigh = torch.from_numpy(rng.normal(size=(97, 16, 10)).astype(np.float32))
    full = tmetrics.canonical_gathered(q, neigh)
    for i in (0, 13, 96):
        one = tmetrics.canonical_gathered(q[i:i + 1], neigh[i:i + 1])
        assert torch.equal(one[0], full[i])
    assert torch.equal(tmetrics.gathered_dist(q, neigh, block=8), full)


def test_canonical_topk_matches_jax():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(50, 6)).astype(np.float32)
    neigh = rng.normal(size=(50, 7, 6)).astype(np.float32)
    ids = rng.integers(0, 1000, (50, 7)).astype(np.int64)
    ids[::5, -2:] = -1
    jd, ji = jmetrics.canonical_topk(q, ids, neigh)
    td, ti = tmetrics.canonical_topk(torch.from_numpy(q),
                                     torch.from_numpy(ids),
                                     torch.from_numpy(neigh))
    np.testing.assert_array_equal(ti.numpy(), ji)
    fin = np.isfinite(jd)
    assert (np.isfinite(td.numpy()) == fin).all()
    assert _ulps(td.numpy()[fin], jd[fin]).max() <= ULP_BOUND


@pytest.mark.parametrize("data", ["gaussian", "forest"])
def test_brute_force_matches_jax(data):
    if data == "gaussian":
        rng = np.random.default_rng(3)
        s = rng.normal(size=(700, 5)).astype(np.float32)
        r = rng.normal(size=(90, 5)).astype(np.float32)
    else:
        s = rt.forest_like(900, 10, seed=0)
        r = rt.forest_like(90, 10, seed=1)
    jd, ji = jbase.brute_force_knn(r, s, 7)
    td, ti = rt.brute_force_knn(r, s, 7, device="cpu")
    assert ti.dtype == np.int64 and td.dtype == np.float32
    assert _ulps(td, jd).max() <= ULP_BOUND
    # ids agree except among exactly tied distances
    mism = ti != ji
    assert (_ulps(td[mism], jd[mism]) <= ULP_BOUND).all()
    if data == "gaussian":
        assert not mism.any()


def test_forest_like_is_the_jax_generator():
    np.testing.assert_array_equal(rt.forest_like(500, 10, seed=4),
                                  j_forest_like(500, 10, seed=4))


def test_obs_registry_is_the_ports_own():
    from repro import obs as jobs
    assert obs.metrics.REGISTRY is not jobs.metrics.REGISTRY
    s = rt.forest_like(400, 4, seed=0)
    cfg = rt.JoinConfig(k=3, n_pivots=8, tile_r=16, tile_s=64)
    idx = rt.build_index(s, cfg, device="cpu")
    with obs.metrics.scoped() as reg, jobs.metrics.scoped() as jreg, \
            obs.capture() as tr:
        rt.knn_join_batched(s[:40], index=idx, megastep=True, device="cpu")
    names = {sp.name for sp in tr.spans()}
    assert {"megastep.refresh", "megastep.device_step",
            "megastep.fetch"} <= names
    snap = reg.snapshot()
    assert snap["megastep_payload_refresh_total"] == 1.0
    assert snap["megastep_finalize_s_count"] == 1.0
    assert jreg.snapshot() == {}
