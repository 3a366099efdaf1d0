"""The paper's §6 workload, port vs JAX package, on the CPU: the dataset
generators, the H-BRJ and PBJ baselines (ids, distances and the §6
``JoinStats``), the L1 / L∞ oracle, and the ``launch.join`` CLI.

Tolerances: generators bit-equal (numpy in both packages); distances
within ``ULP_BOUND`` (ROADMAP C1), ids equal except among tied
distances; the stats fields equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import JoinConfig as JConfig  # noqa: E402
from repro.core import baselines as jb  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.launch import join as launch_join  # noqa: E402

from torch_parity import ULP_BOUND, assert_same_join, ulps  # noqa: E402

STATS = ("replicas_s", "pairs_computed", "tiles_total", "tiles_visited",
         "pivot_pairs_computed", "selectivity", "shuffle_tuples", "n_r",
         "n_s")


@pytest.mark.parametrize("gen", [
    ("clustered_like", (700, 6, 3), {}),
    ("clustered_like", (300, 3, 1), {"n_centers": 5, "centers_seed": 7}),
    ("osm_like", (900, 4), {}), ("forest_like", (800, 10, 2), {}),
    ("expand", 1, {}), ("expand", 2, {}), ("expand", 3, {})])
def test_generators_bit_equal(gen):
    name, args, kw = gen
    if name == "expand":
        base = rt.forest_like(600, 10, seed=5)
        np.testing.assert_array_equal(rt.expand_dataset(base, args),
                                      jdata.expand_dataset(base, args))
        assert rt.expand_dataset(base, args).shape == (600 * args, 10)
        return
    got = getattr(rt, name)(*args, **kw)
    want = getattr(jdata, name)(*args, **kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _dataset(kind):
    if kind == "forest":
        return rt.forest_like(1200, 10, seed=3)
    if kind == "osm":
        return rt.osm_like(1500, seed=4)
    return rt.clustered_like(1000, 6, seed=5)


def _assert_stats_equal(got, want):
    for f in STATS:
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("kind", ["forest", "osm", "clustered"])
def test_hbrj_matches_jax(kind):
    """The same blocks and the same §6 counts; distances exact. The JAX
    package's block join selects on the expanded d² over blocks that
    span the whole dataset and misses true neighbours on OSM-like rows
    (ROADMAP C15): ids and distances are held against it where it is
    exact, and the port against the float64 brute force everywhere."""
    x = _dataset(kind)
    r = x[::3]
    want = jb.hbrj_join(r, x, 7, n_reducers=9, seed=2)
    got = rt.hbrj_join(r, x, 7, n_reducers=9, seed=2, device="cpu")
    assert got.indices.dtype == np.int64
    _assert_stats_equal(got.stats, want.stats)
    bd, _ = rt.brute_force_knn(r, x, 7, device="cpu")
    np.testing.assert_array_equal(got.distances, bd)
    jax_exact = (ulps(want.distances, bd) <= ULP_BOUND).all(axis=1)
    assert jax_exact.mean() > 0.95
    assert_same_join(got.distances[jax_exact], got.indices[jax_exact],
                     want.distances[jax_exact], want.indices[jax_exact])
    if kind != "osm":
        assert jax_exact.all()


@pytest.mark.parametrize("kind", ["forest", "osm", "clustered"])
def test_pbj_matches_jax(kind):
    """Results exact and equal to the JAX package's but at ties; the
    shuffle and pivot counts equal. The port's rings compare |q, p_j|
    and |p_j, s| taken in float64 where the JAX package compares K-A's
    float32 distances (ROADMAP C15), so a pair on a ring's edge may
    flip: the pair and tile counts are held within 0.1 % (2 pairs of
    100,307 differ on the clustered rows)."""
    x = _dataset(kind)
    kw = dict(k=6, n_pivots=24, tile_s=128, seed=1)
    want = jb.pbj_join(x, x, 6, JConfig(**kw), n_reducers=9)
    got = rt.pbj_join(x, x, 6, rt.JoinConfig(**kw), n_reducers=9,
                      device="cpu")
    assert_same_join(got.distances, got.indices, want.distances,
                     want.indices)
    for f in ("replicas_s", "pivot_pairs_computed", "n_r", "n_s",
              "shuffle_tuples"):
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    for f in ("pairs_computed", "tiles_visited", "tiles_total",
              "selectivity"):
        assert getattr(got.stats, f) == pytest.approx(
            getattr(want.stats, f), rel=1e-3), f
    assert 0 < got.stats.selectivity < 1
    bd, _ = rt.brute_force_knn(x, x, 6, device="cpu")
    np.testing.assert_array_equal(got.distances, bd)


def test_pruned_reducer_exact_on_map_coordinates():
    """OSM-like rows (lon/lat to ±180): the float32 phase-1 distances
    would prune true neighbours in the ring and hyperplane tests (C15);
    the port's PGBJ and PBJ stay exact against the float64 oracle."""
    x = rt.osm_like(3000, seed=16)
    bd, _ = rt.brute_force_knn(x, x, 10, device="cpu")
    pgbj = rt.knn_join(x, x, config=rt.JoinConfig(k=10, n_pivots=32,
                                                  n_groups=9), device="cpu")
    pbj = rt.pbj_join(x, x, 10, rt.JoinConfig(k=10, n_pivots=32),
                      n_reducers=9, device="cpu")
    for res in (pgbj, pbj):
        np.testing.assert_array_equal(res.distances, bd)


# map coordinates where the float32 expansion under-reads |r, p_i| and
# |p_i, s'| by more than θ's pad (found by a seeded search; every one
# made the pruned reducer miss while θ was built from those distances)
THETA_ATTACK_ORIGINS = [(148.53086853027344, 76.4748306274414),
                        (143.49000549316406, 86.75362396240234),
                        (165.26828002929688, 40.136924743652344)]


@pytest.mark.parametrize("origin", THETA_ATTACK_ORIGINS)
@pytest.mark.parametrize("route", ["pruned", "dense", "gather", "megastep"])
def test_theta_sound_when_tight(route, origin):
    """θ (Thm 3) made tight by construction: r, p_i and s' collinear with
    |r, s'| = U + |p_i, s'| = θ, and the true nearest neighbour s* ∈ P_j
    at θ − 1e-3, where Thm 2's ring for P_j keeps it only while θ is not
    under-read. The padded θ must cover the true k-th distance, and
    every route must find s*."""
    o = np.asarray(origin, np.float64)
    a, b, c, eps = 0.1, 0.1, 0.05, 1e-3
    th = a + b
    piv = np.stack([o + [a, 0], o + [0, th + c]]).astype(np.float32)
    r = o[None].astype(np.float32)
    s = np.stack([o + [a + b, 0], o + [0, th - eps]]).astype(np.float32)
    cfg = rt.JoinConfig(k=1, n_pivots=2, n_groups=1,
                        reducer="gather" if route == "megastep" else route)
    idx = rt.build_index(s, cfg, pivots=piv, device="cpu")
    bd, bi = rt.brute_force_knn(r, s, 1, device="cpu")
    assert bi[0, 0] == 1
    plan = rt.core.plan_queries(r, idx, cfg)
    theta = rt.core.pad_theta(plan.theta[plan.r_part.long()]).numpy()
    true = np.sqrt(((r.astype(np.float64) - s[1]) ** 2).sum())
    assert theta[0] >= true
    res = rt.knn_join(r, index=idx, megastep=route == "megastep",
                      device="cpu")
    np.testing.assert_array_equal(res.distances, bd)
    np.testing.assert_array_equal(res.indices, bi)


def test_assignment_excess_covers_a_misassigned_row():
    """Rows within float32 noise of the bisector of two pivots at map
    coordinates: where K-A picks the farther pivot, the partition's
    excess is the float64 |s, p_j|² − min_l |s, p_l|², and 0 where every
    row sits in its own cell."""
    from repro_torch.core.partition import assignment_excess
    from repro_torch.kernels import ops
    rng = np.random.default_rng(19)
    piv = np.array([[171.25, 61.5], [171.5, 61.5], [-20.0, 5.0]],
                   np.float32)
    y = rng.uniform(61.0, 62.0, 400)
    x = 171.375 + rng.uniform(-2e-5, 2e-5, 400)
    rows = np.stack([x, y], 1).astype(np.float32)
    rows_t, piv_t = torch.from_numpy(rows), torch.from_numpy(piv)
    pid, _ = ops.assign(rows_t, piv_t)
    pid = pid.numpy()
    d2 = ((rows[:, None, :].astype(np.float64) - piv[None]) ** 2).sum(-1)
    gap = d2[np.arange(400), pid] - d2.min(1)
    assert (gap > 0).any()               # K-A misassigned some rows
    want = np.zeros(3)
    np.maximum.at(want, pid, gap)
    got = assignment_excess(rows_t, piv_t, torch.from_numpy(pid)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert got[2] == 0.0


@pytest.mark.parametrize("n_reducers", [1, 4, 16])
def test_baselines_any_reducer_count(n_reducers):
    """√N × √N blocks for any N (1: one reducer, the brute force)."""
    x = _dataset("clustered")[:400]
    bd, _ = rt.brute_force_knn(x, x, 5, device="cpu")
    for res in (rt.hbrj_join(x, x, 5, n_reducers=n_reducers, device="cpu"),
                rt.pbj_join(x, x, 5, rt.JoinConfig(k=5, n_pivots=16),
                            n_reducers=n_reducers, device="cpu")):
        np.testing.assert_array_equal(res.distances, bd)
        root = int(np.sqrt(n_reducers))
        assert res.stats.replicas_s == root * 400 + (root - 1) * 400


@pytest.mark.parametrize("metric", ["l1", "linf"])
@pytest.mark.parametrize("kind", ["forest", "gaussian"])
def test_metric_oracle_matches_jax(metric, kind):
    if kind == "forest":
        s, r = rt.forest_like(900, 10, seed=6), rt.forest_like(70, 10, seed=7)
    else:
        rng = np.random.default_rng(8)
        s = rng.normal(size=(900, 5)).astype(np.float32)
        r = rng.normal(size=(70, 5)).astype(np.float32)
    jd, ji = jb.brute_force_knn(r, s, 8, metric=metric)
    d, i = rt.brute_force_knn(r, s, 8, metric=metric, device="cpu")
    assert_same_join(d, i, jd, ji)
    # exact against the definition, in float64
    diff = np.abs(r[:, None, :].astype(np.float64) - s[None].astype(
        np.float64))
    full = diff.sum(-1) if metric == "l1" else diff.max(-1)
    kth = np.sort(full, axis=1)[:, 7]
    np.testing.assert_allclose(d[:, -1], kth, rtol=1e-6)


@pytest.mark.parametrize("metric", ["l2", "l1", "linf"])
def test_oracle_tile_cut_changes_no_bit(metric, monkeypatch):
    """A difference tile that memory cuts to a few rows (or one) gives
    the same bits as the default."""
    s, r = rt.forest_like(500, 10, seed=9), rt.forest_like(50, 10, seed=10)
    d0, i0 = rt.brute_force_knn(r, s, 6, metric=metric, device="cpu")
    for cap in (1, 3 * 500 * 10 * 8):
        monkeypatch.setattr(tb, "DIFF_TILE_BYTES", cap)
        d, i = rt.brute_force_knn(r, s, 6, metric=metric, device="cpu")
        np.testing.assert_array_equal(d, d0)
        np.testing.assert_array_equal(i, i0)


def test_metric_knn_join_against_oracle():
    """PGBJ under L1 / L∞ (the metric-generic reducers) is exact against
    the new oracle."""
    x = rt.forest_like(900, 10, seed=11)
    for metric in ("l1", "linf"):
        cfg = rt.JoinConfig(k=5, n_pivots=16, metric=metric)
        res = rt.knn_join(x[:200], x, config=cfg, device="cpu")
        bd, bi = rt.brute_force_knn(x[:200], x, 5, metric=metric,
                                    device="cpu")
        assert_same_join(res.distances, res.indices, bd, bi)


@pytest.mark.parametrize("method", ["pgbj", "pbj", "hbrj"])
def test_launch_join_verifies(method, capsys):
    res = launch_join.main(["--n", "1200", "--k", "5", "--pivots", "32",
                            "--groups", "4", "--method", method,
                            "--expand", "2", "--device", "cpu",
                            "--verify"])
    out = capsys.readouterr().out
    assert f"{method} on forest n=2400 k=5" in out
    assert "verified vs brute force on 500 samples: True" in out
    assert res.distances.shape == (2400, 5)


def test_launch_join_osm_and_distributed():
    res = launch_join.main(["--dataset", "osm", "--n", "800", "--k", "4",
                            "--pivots", "16", "--device", "cpu",
                            "--verify"])
    assert res.indices.shape == (800, 4)
    # --distributed: more shards than the one CPU only with --simulate
    with pytest.raises(ValueError, match="--simulate"):
        launch_join.main(["--n", "100", "--distributed", "--shards", "2",
                          "--device", "cpu"])
    res = launch_join.main(["--n", "800", "--k", "4", "--pivots", "16",
                            "--device", "cpu", "--distributed", "--shards",
                            "3", "--simulate", "--verify"])
    assert res.indices.shape == (800, 4)
    # on map coordinates the sharded megastep carries the K-G routes'
    # float32 selection (ROADMAP C15), so the OSM run is not verified
    res = launch_join.main(["--dataset", "osm", "--n", "800", "--k", "4",
                            "--pivots", "16", "--device", "cpu",
                            "--distributed", "--shards", "3", "--simulate"])
    assert res.indices.shape == (800, 4)


def test_launch_join_verify_catches_a_near_miss():
    """``--verify`` holds distances bit for bit (on Forest-like rows a
    neighbour one unit of d² farther is less than 1e-2 away): a distance
    one ulp off fails it, as does a duplicated id or an id beyond the
    true k-th distance."""
    x = rt.forest_like(1500, 10, seed=12)
    sample = np.arange(0, 1500, 7)
    bd, bi = rt.brute_force_knn(x[sample], x, 5, device="cpu")
    assert launch_join.verify_sample(x, sample, bd, bi, bd, bi)
    d = bd.copy()
    d[3, -1] = np.nextafter(d[3, -1], np.float32(np.inf))
    assert not launch_join.verify_sample(x, sample, d, bi, bd, bi)
    ids = bi.copy()
    ids[4, -1] = ids[4, 0]
    assert not launch_join.verify_sample(x, sample, bd, ids, bd, bi)
    far = np.argmax(((x - x[sample[5]]) ** 2).sum(1))
    ids = bi.copy()
    ids[5, -1] = far
    assert not launch_join.verify_sample(x, sample, bd, ids, bd, bi)
