"""The host-planned PGBJ path, port vs JAX package: bounds, grouping,
query plans, tile schedules, the three reducers and ``knn_join`` on the
CPU (the kernels' plain versions), from the same numpy inputs and the
same pivots (a JAX-built index carried across with
``sindex_from_arrays``). Plus the port's own invariants: the megastep
equals the host-planned path bitwise, batched equals one-shot for any
split, and both packages take the same route by default.

Tolerances: integer and boolean outputs (assignments, groups, schedules,
counts, masks, ``JoinStats`` integer fields) exactly; θ and LB within 4
ulp (XLA contracts the JAX graph into FMAs, ROADMAP Queue C1); final
distances within 4 ulp and ids equal except among tied distances."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import JoinConfig as JConfig  # noqa: E402
from repro.core import bounds as jB  # noqa: E402
from repro.core import brute_force_knn as j_brute  # noqa: E402
from repro.core import build_index as j_build_index  # noqa: E402
from repro.core import grouping as jG  # noqa: E402
from repro.core import knn_join as j_knn_join  # noqa: E402
from repro.core import knn_join_batched as j_batched  # noqa: E402
from repro.core import plan_queries as j_plan  # noqa: E402
from repro.core import schedule as jS  # noqa: E402
from repro.core.stream import StreamJoinEngine as JStream  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.core import bounds as B  # noqa: E402
from repro_torch.core import grouping as G  # noqa: E402
from repro_torch.core import schedule as S  # noqa: E402
from repro_torch.core.types import SummaryTable  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

from torch_parity import (ULP_BOUND, assert_d_close,  # noqa: E402
                          assert_same_join, data, index_arrays, ulps)

CFG = dict(k=10, n_pivots=24, n_groups=4, tile_r=32, tile_s=64)


def _pair(kind="gaussian", seed=0, **kw):
    """A JAX index and the port's copy of it, with S and R."""
    s, r = data(kind, seed=seed)
    cfg = dict(CFG, **kw)
    jidx = j_build_index(s, JConfig(**cfg))
    tidx = rt.sindex_from_arrays(index_arrays(jidx), rt.JoinConfig(**cfg),
                                 device="cpu")
    return s, r, jidx, tidx


def _t(x):
    return torch.from_numpy(np.array(x))


def _table(t):
    return SummaryTable(counts=_t(t.counts), lower=_t(t.lower),
                        upper=_t(t.upper),
                        knn_dists=None if t.knn_dists is None
                        else _t(t.knn_dists))


def _stats_fields(st):
    return {f.name: getattr(st, f.name) for f in dataclasses.fields(st)}


@pytest.mark.parametrize("kind", ["gaussian", "forest"])
def test_bounds_match_jax(kind):
    """compute_theta + replication_lower_bounds bit for bit against the
    JAX host functions; the fused theta_and_lb within 4 ulp of the JAX
    jitted one; hyperplane and ring bounds against theirs."""
    s, r, jidx, tidx = _pair(kind)
    jp = j_plan(r, jidx)
    t_r, t_s = _table(jp.t_r), _table(jidx.t_s)
    th = B.compute_theta(_t(jidx.pivd), t_r, t_s, CFG["k"])
    jth = jB.compute_theta(jidx.pivd, jp.t_r, jidx.t_s, CFG["k"])
    np.testing.assert_array_equal(th.numpy(), jth)
    lb = B.replication_lower_bounds(_t(jidx.pivd), t_r, th)
    np.testing.assert_array_equal(
        lb.numpy(), jB.replication_lower_bounds(jidx.pivd, jp.t_r, jth))
    th2, lb2 = B.theta_and_lb(_t(jidx.pivd), t_r, t_s, CFG["k"])
    fin = np.isfinite(jp.theta)
    assert (np.isfinite(th2.numpy()) == fin).all()
    assert ulps(th2.numpy()[fin], jp.theta[fin]).max() <= ULP_BOUND
    lfin = np.isfinite(jp.lb)
    assert (np.isfinite(lb2.numpy()) == lfin).all()
    assert ulps(lb2.numpy()[lfin], jp.lb[lfin]).max() <= ULP_BOUND
    # Thm 1 / Thm 2 helpers on the same query→pivot distances
    from repro.core.metrics import pairwise_dist
    qp = pairwise_dist(r, jidx.pivots)
    hd = B.hyperplane_distances(_t(qp), _t(jidx.pivd), _t(jp.r_part))
    jhd = jB.hyperplane_distances(qp, jidx.pivd, jp.r_part)
    np.testing.assert_array_equal(hd.numpy(), jhd)
    th_q = jth[jp.r_part]
    parts = np.arange(0, CFG["n_pivots"], 3)
    lo, hi = B.ring_bounds(_t(qp), _t(th_q), t_s, _t(parts))
    jlo, jhi = jB.ring_bounds(qp, th_q, jidx.t_s, parts)
    np.testing.assert_array_equal(lo.numpy(), jlo)
    np.testing.assert_array_equal(hi.numpy(), jhi)


@pytest.mark.parametrize("strategy", ["geometric", "greedy", "none"])
def test_grouping_matches_jax(strategy):
    """Groups, group LBs and replication counts exactly, on θ / LB
    carried from the JAX plan (greedy choices branch on float
    comparisons)."""
    s, r, jidx, tidx = _pair("forest", grouping=strategy,
                             n_groups=6 if strategy != "none" else 24)
    jp = j_plan(r, jidx)
    n_groups = jp.n_groups
    groups = G.group_partitions(strategy, _t(jidx.pivd), _table(jp.t_r),
                                n_groups, lb=_t(jp.lb), t_s=_table(jidx.t_s))
    np.testing.assert_array_equal(groups, jp.groups)
    lbg = B.group_lower_bounds(_t(jp.lb), _t(groups), n_groups)
    np.testing.assert_array_equal(lbg.numpy(), jp.lb_group)
    np.testing.assert_array_equal(
        G.replication_count_partitions(lbg, _table(jidx.t_s)),
        jG.replication_count_partitions(jp.lb_group, jidx.t_s))
    np.testing.assert_array_equal(
        G.replication_count_exact(lbg, tidx.s_part, tidx.s_dist),
        jG.replication_count_exact(jp.lb_group, jidx.s_part, jidx.s_dist))
    for g in range(n_groups):
        np.testing.assert_array_equal(
            tidx.replica_mask_sorted(lbg, g).numpy(),
            jidx.replica_mask_sorted(jp.lb_group, g))


@pytest.mark.parametrize("kind", ["gaussian", "forest"])
def test_plan_queries_matches_jax(kind):
    s, r, jidx, tidx = _pair(kind)
    jp = j_plan(r, jidx)
    tp = rt.plan_queries(r, tidx)
    np.testing.assert_array_equal(tp.r_part.numpy(), jp.r_part)
    assert_d_close(tp.r_dist.numpy(), jp.r_dist,
                   np.concatenate([r, jidx.pivots]))
    np.testing.assert_array_equal(tp.t_r.counts.numpy(), jp.t_r.counts)
    fin = np.isfinite(jp.theta)
    assert ulps(tp.theta.numpy()[fin], jp.theta[fin]).max() <= ULP_BOUND
    np.testing.assert_array_equal(tp.groups.numpy(), jp.groups)
    assert tp.n_groups == jp.n_groups and tp.n_r == r.shape[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tile_schedule_matches_jax(seed):
    """build_tile_schedule: the visit mask a superset of JAX's (the
    port's is the sound form, ROADMAP C15), the compacted schedule and
    the counts those of that mask, and the pivot-pair count."""
    s, r, jidx, tidx = _pair("forest", seed=seed)
    jp = j_plan(r, jidx)
    sel = np.where(jp.group_of_r() == seed % jp.n_groups)[0]
    order = np.argsort(jp.r_part[sel], kind="stable")
    rr, rp = r[sel][order], jp.r_part[sel][order]
    mask = jidx.replica_mask_sorted(jp.lb_group, seed % jp.n_groups)
    sp, sd = jidx.s_part_sorted[mask], jidx.s_dist_sorted[mask]
    jst, tst = rt.JoinStats(), rt.JoinStats()
    want = jS.build_tile_schedule(
        rr, rp, sp, sd, jidx.pivots, jidx.pivd, jp.theta, bm=32, bn=64,
        knn_dists=jidx.t_s.knn_dists, k=CFG["k"], stats=jst)
    got = S.build_tile_schedule(
        _t(rr), _t(rp), _t(sp), _t(sd), _t(jidx.pivots), _t(jidx.pivd),
        _t(jp.theta), bm=32, bn=64, knn_dists=_t(jidx.t_s.knn_dists),
        k=CFG["k"], stats=tst, tile_block=3)
    visit = got.visit_mask.numpy()
    assert not (want.visit_mask & ~visit).any()
    assert want.n_visits <= got.n_visits < visit.size      # still prunes
    sched, cnt = jS.compact_visit_mask(visit)
    np.testing.assert_array_equal(got.schedule.numpy(), sched)
    np.testing.assert_array_equal(got.counts.numpy(), cnt)
    assert tst.pivot_pairs_computed == jst.pivot_pairs_computed


def test_compact_visit_mask_matches_jax():
    rng = np.random.default_rng(4)
    visit = rng.random((13, 29)) < 0.3
    visit[np.arange(13), rng.integers(0, 29, 13)] = True
    for width in (None, 40):
        sched, cnt = S.compact_visit_mask(_t(visit), max_visits=width)
        jsched, jcnt = jS.compact_visit_mask(visit, max_visits=width)
        np.testing.assert_array_equal(sched.numpy(), jsched)
        np.testing.assert_array_equal(cnt.numpy(), jcnt)
    visit[3] = False
    with pytest.raises(ValueError, match="empty rows"):
        S.compact_visit_mask(_t(visit))


def test_topk_merge_matches_jax():
    from repro.core.join import topk_merge as j_merge
    from repro_torch.core.join import topk_merge
    rng = np.random.default_rng(5)
    bd = np.sort(rng.random((6, 5)).astype(np.float32), axis=1)
    bi = rng.integers(0, 100, (6, 5))
    nd = rng.random((6, 9)).astype(np.float32)
    ni = rng.integers(100, 200, (6, 9))
    d, i = topk_merge(_t(bd), _t(bi), _t(nd), _t(ni), 5)
    jd, ji = j_merge(bd, bi, nd, ni, 5)
    np.testing.assert_array_equal(d.numpy(), jd)
    np.testing.assert_array_equal(i.numpy(), ji)


@pytest.mark.parametrize("reducer", ["gather", "pruned", "dense"])
@pytest.mark.parametrize("kind", ["gaussian", "forest"])
def test_knn_join_reducers_match_jax(reducer, kind):
    """knn_join over the carried index, per reducer: results against
    the JAX package and its brute force, and the §6 JoinStats integer
    fields exactly. The gather reducer on the CPU runs the scheduled
    gather kernel's plain version (no launch counted)."""
    s, r, jidx, tidx = _pair(kind, reducer=reducer)
    ops.reset_launch_counts()
    got = rt.knn_join(r, index=tidx, device="cpu")
    assert set(ops.launch_counts().values()) == {0}
    want = j_knn_join(r, index=jidx)
    bd, bi = j_brute(r, s, CFG["k"])
    assert got.indices.dtype == np.int64
    assert got.distances.dtype == np.float32
    for ref in (want, (bd, bi)):
        ref_d, ref_i = (ref.distances, ref.indices) if hasattr(
            ref, "distances") else ref
        assert_same_join(got.distances, got.indices, ref_d, ref_i,
                         exact_ids=kind == "gaussian")
    gs, ws = _stats_fields(got.stats), _stats_fields(want.stats)
    for name in ("n_r", "n_s", "replicas_s", "pairs_computed",
                 "pivot_pairs_computed", "tiles_total", "tiles_visited",
                 "n_batches"):
        assert gs[name] == ws[name], name


@pytest.mark.parametrize("metric", ["l1", "linf"])
def test_knn_join_other_metrics_match_jax(metric):
    """L1 / L∞ through the pruned reducer and the metric-generic
    schedule walk of the gather reducer."""
    for reducer in ("pruned", "gather"):
        s, r, jidx, tidx = _pair("gaussian", metric=metric, reducer=reducer)
        got = rt.knn_join(r[:120], index=tidx, device="cpu")
        want = j_knn_join(r[:120], index=jidx)
        assert_same_join(got.distances, got.indices, want.distances,
                         want.indices)


def test_one_shot_knn_join_selects_pivots_from_r():
    """The paper's one-shot pipeline: pivots from R in both packages
    (the same numpy draw), then the same join."""
    s, r = data("forest", n_s=2000, n_r=250, seed=3)
    cfg = dict(CFG, reducer="gather")
    got = rt.knn_join(r, s, config=rt.JoinConfig(**cfg), device="cpu")
    want = j_knn_join(r, s, config=JConfig(**cfg))
    assert_same_join(got.distances, got.indices, want.distances,
                     want.indices)
    assert got.stats.pivot_pairs_computed == want.stats.pivot_pairs_computed
    plan = rt.core.plan_join(r, s, rt.JoinConfig(**cfg), device="cpu")
    again = rt.knn_join(r, plan=plan, device="cpu")
    np.testing.assert_array_equal(again.distances, got.distances)
    with pytest.raises(ValueError, match="plan"):
        rt.knn_join(r, plan=plan, megastep=True, device="cpu")


@pytest.mark.parametrize("kind", ["gaussian", "forest"])
@pytest.mark.parametrize("reducer", ["gather", "pruned", "dense"])
def test_megastep_equals_host_path_bitwise(kind, reducer):
    """The milestone inside the port: the fused megastep and every
    host-planned reducer report the same canonical distances."""
    s, r = data(kind, seed=6)
    cfg = rt.JoinConfig(**dict(CFG, reducer=reducer))
    idx = rt.build_index(s, cfg, device="cpu")
    host = rt.knn_join(r, index=idx, device="cpu")
    mega = rt.knn_join(r, index=idx, megastep=True, device="cpu")
    np.testing.assert_array_equal(mega.distances, host.distances)
    mism = mega.indices != host.indices
    np.testing.assert_array_equal(mega.distances[mism],
                                  host.distances[mism])
    assert mega.stats.n_r == host.stats.n_r == r.shape[0]


@pytest.mark.parametrize("splits", [(1,), (37, 64, 199), (128, 128, 44)])
def test_host_batched_equals_one_shot_any_split(splits):
    s, r = data("gaussian", seed=3)
    cfg = rt.JoinConfig(**dict(CFG, reducer="gather"))
    idx = rt.build_index(s, cfg, device="cpu")
    one = rt.knn_join(r, index=idx, device="cpu")
    parts = np.split(r, np.cumsum(splits)[:-1]) if len(splits) > 1 else [r]
    many = rt.knn_join_batched(iter(parts), index=idx, device="cpu")
    np.testing.assert_array_equal(many.distances, one.distances)
    np.testing.assert_array_equal(many.indices, one.indices)
    assert many.stats.n_batches == len(parts)


def test_default_route_is_the_host_path_in_both_packages():
    """The same calls with no ``megastep=`` take the same route in both
    packages: the host-planned path (no megastep engine, no async
    half)."""
    s, r, jidx, tidx = _pair("gaussian", reducer="gather")
    jeng, teng = JStream(jidx), rt.StreamJoinEngine(tidx, device="cpu")
    assert jeng.megastep_engine is None and teng.megastep_engine is None
    assert jeng.can_dispatch is teng.can_dispatch is False
    with pytest.raises(RuntimeError, match="dispatch"):
        teng.dispatch(r)
    jst, tst = JStream(jidx).join_batch(r[:50]), teng.join_batch(r[:50])
    assert_same_join(tst[0], tst[1], jst[0], jst[1], exact_ids=True)
    got = rt.knn_join_batched(r, index=tidx, batch_size=128, device="cpu")
    want = j_batched(r, index=jidx, batch_size=128)
    assert_same_join(got.distances, got.indices, want.distances,
                     want.indices, exact_ids=True)
    assert (got.stats.tiles_visited, got.stats.n_batches) == (
        want.stats.tiles_visited, want.stats.n_batches)
    host = teng.join_batch_host(r[:50])
    np.testing.assert_array_equal(host[0], tst[0])

