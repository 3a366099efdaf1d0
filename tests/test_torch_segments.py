"""The port's mutable segmented index (``repro_torch.core.segments``)
against the JAX package's, and its routes against each other.

The same numpy rows go through the same insert / delete / seal /
compact interleavings on both packages' ``MutableIndex``: allocated
ids, versions, segment and tombstone counts, the live rows and
``compact``'s old ids agree exactly. Joins: the port's distances within
4 ulp of the JAX package's (XLA contracts the canonical chain into
FMAs; ROADMAP Queue C1) and ids equal except among those ties; inside
the port every route — host-planned (dense, pruned, gather), batched,
megastep, quantized — is bitwise equal to a fresh ``build_index`` over
the survivors (ids through the remap). Small sizes, CPU plain
versions."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch as rt  # noqa: E402
from repro.core import JoinConfig as JConfig  # noqa: E402
from repro.core import MutableIndex as JMutable  # noqa: E402
from repro.core import knn_join as jknn_join  # noqa: E402
from repro_torch.serve import faultinject  # noqa: E402

from torch_parity import assert_d_close, assert_same_join  # noqa: E402


def _data(rng, n, dim=6, scale=3.0):
    return rng.normal(size=(n, dim)).astype(np.float32) * scale


def _configs(**kw):
    return JConfig(**kw), rt.JoinConfig(**kw)


def _oracle(mi, r, cfg):
    """A fresh static index over the survivors; its ids remapped into
    the mutable index's global id space."""
    rows, gids = mi.live_rows()
    res = rt.knn_join(r, config=cfg, index=rt.build_index(rows, cfg,
                                                          device="cpu"),
                      device="cpu")
    return res.distances, np.where(res.indices >= 0,
                                   gids[np.clip(res.indices, 0, None)], -1)


def _check(mi, r, cfg):
    """The host route bitwise equal to the fresh-index oracle."""
    res = rt.knn_join(r, config=cfg, index=mi, device="cpu")
    od, oi = _oracle(mi, r, cfg)
    np.testing.assert_array_equal(res.distances, od)
    np.testing.assert_array_equal(res.indices, oi)
    return res


def _same_state(mj, mt):
    assert (mt.version, mt.n_s, mt.n_segments, mt.n_tombstones,
            mt.n_buffered, len(mt.segments)) == (
        mj.version, mj.n_s, mj.n_segments, mj.n_tombstones, mj.n_buffered,
        len(mj.segments))
    np.testing.assert_array_equal(mt.tombstones_sorted(),
                                  mj.tombstones_sorted())
    (rt_rows, rt_ids), (rj_rows, rj_ids) = mt.live_rows(), mj.live_rows()
    np.testing.assert_array_equal(rt_rows, rj_rows)
    np.testing.assert_array_equal(rt_ids, rj_ids)


@pytest.mark.parametrize("reducer", ["dense", "pruned", "gather"])
def test_interleaving_matches_jax(reducer):
    """insert → seal → delete → buffer → compact → delete → insert on
    both packages: state exactly equal, joins within 4 ulp of the JAX
    package's, bitwise equal to the port's fresh-index oracle."""
    rng = np.random.default_rng(0)
    cfg_j, cfg = _configs(k=5, n_pivots=16, n_groups=4, seed=1,
                          reducer=reducer)
    s = _data(rng, 300)
    r = _data(rng, 40)
    mj = JMutable.build(s, cfg_j, seal_threshold=50)
    mt = rt.MutableIndex.build(s, cfg, seal_threshold=50, device="cpu")

    def step():
        _same_state(mj, mt)
        got = _check(mt, r, cfg)
        want = jknn_join(r, config=cfg_j, index=mj)
        assert_same_join(got.distances, got.indices, want.distances,
                         want.indices)
        return got

    step()
    new = _data(rng, 60)
    np.testing.assert_array_equal(mt.insert(new), mj.insert(new))
    assert len(mt.segments) == 2                  # crossed the threshold
    step()
    mt.delete(np.arange(40))
    mj.delete(np.arange(40))
    new = _data(rng, 20)
    np.testing.assert_array_equal(mt.insert(new), mj.insert(new))
    assert mt.n_buffered == 20 and mt.n_segments == 3
    res = step()
    assert res.stats.n_segments == 3 and res.stats.n_tombstones == 40
    pre = res.distances
    np.testing.assert_array_equal(mt.compact(), mj.compact())
    assert (mt.n_segments, mt.n_tombstones, mt.n_buffered) == (1, 0, 0)
    res = step()
    np.testing.assert_array_equal(res.distances, pre)   # same live set
    mt.delete(res.indices[0, :2])
    mj.delete(res.indices[0, :2])
    new = _data(rng, 10)
    np.testing.assert_array_equal(mt.insert(new), mj.insert(new))
    step()


def _mutated(seed=1, *, quantize="none"):
    """A mutable index with a base, a sealed delta, tombstones in both
    and a non-empty write buffer."""
    rng = np.random.default_rng(seed)
    cfg = rt.JoinConfig(k=6, n_pivots=12, n_groups=3, seed=0,
                        reducer="gather", tile_r=16, tile_s=32,
                        quantize=quantize)
    mi = rt.MutableIndex.build(_data(rng, 260), cfg, seal_threshold=70,
                               device="cpu")
    mi.insert(_data(rng, 80))
    mi.delete(np.concatenate([np.arange(0, 30, 3), np.arange(262, 270)]))
    mi.insert(_data(rng, 25))
    assert (len(mi.segments), mi.n_buffered, mi.n_tombstones) == (2, 25, 18)
    return mi, cfg, _data(rng, 45)


@pytest.mark.parametrize("route", [
    "host batched", "megastep one-shot", "megastep batched",
    "quantized one-shot", "quantized batched", "stream engine"])
def test_routes_bitwise_equal_fresh_index(route):
    mi, cfg, r = _mutated()
    od, oi = _oracle(mi, r, cfg)
    calls = {
        "host batched": lambda: rt.knn_join_batched(
            r, index=mi, config=cfg, batch_size=13, device="cpu"),
        "megastep one-shot": lambda: rt.knn_join(
            r, config=cfg, index=mi, megastep=True, device="cpu"),
        "megastep batched": lambda: rt.knn_join_batched(
            r, index=mi, config=cfg, batch_size=13, megastep=True,
            device="cpu"),
        "quantized one-shot": lambda: rt.knn_join(
            r, config=dataclasses.replace(cfg, quant_slack=20), index=mi,
            quantized=True, device="cpu"),
        "quantized batched": lambda: rt.knn_join_batched(
            r, index=mi, config=dataclasses.replace(cfg, quant_slack=20),
            batch_size=16, quantized=True, device="cpu"),
    }
    stats = rt.JoinStats()
    if route == "stream engine":
        d, i = rt.StreamJoinEngine(mi, cfg, megastep="auto", device="cpu") \
            .join_batch(r, stats=stats)
    else:
        res = calls[route]()
        d, i, stats = res.distances, res.indices, res.stats
    np.testing.assert_array_equal(d, od)
    np.testing.assert_array_equal(i, oi)
    assert (stats.n_segments, stats.n_tombstones) == (3, 18)


def test_megastep_payload_follows_the_version():
    """One engine across mutations: the payload is rebuilt only when the
    version moves, and every result is the fresh-index oracle's."""
    mi, cfg, r = _mutated(2)
    eng = rt.MegastepEngine(mi, cfg, device="cpu")
    reg = rt.obs.metrics.REGISTRY
    c = reg.counter("megastep_payload_refresh_total")
    for mutate in (lambda: None, lambda: mi.delete([100, 300]),
                   lambda: mi.insert(_data(np.random.default_rng(3), 50)),
                   mi.compact):
        mutate()
        before = c.value
        d, i = eng.join_batch(r)
        d2, i2 = eng.join_batch(r)
        assert c.value - before == 1                 # once per version
        od, oi = _oracle(mi, r, cfg)
        np.testing.assert_array_equal(d, od)
        np.testing.assert_array_equal(i, oi)
        np.testing.assert_array_equal(d2, d)


def test_segment_offset_ids_survive_int32_overflow():
    """Global ids past 2³¹ flow through planning, both engines and the
    stream state unchanged, as in the JAX package."""
    rng = np.random.default_rng(2)
    cfg_j, cfg = _configs(k=4, n_pivots=8, n_groups=2, seed=0)
    s, new, r = _data(rng, 100), _data(rng, 12), _data(rng, 9)
    mj = JMutable.build(s, cfg_j, seal_threshold=10)
    mt = rt.MutableIndex.build(s, cfg, seal_threshold=10, device="cpu")
    mj._next_id = mt._next_id = 2 ** 31 + 7    # a long-lived id watermark
    big = mt.insert(new)
    np.testing.assert_array_equal(big, mj.insert(new))
    assert big[0] == 2 ** 31 + 7 and len(mt.segments) == 2
    want = jknn_join(r, config=cfg_j, index=mj)
    for res in (_check(mt, r, cfg),
                rt.knn_join_batched(r, index=mt, config=cfg, batch_size=4,
                                    device="cpu"),
                rt.knn_join_batched(r, index=mt, config=cfg, batch_size=4,
                                    megastep=True, device="cpu")):
        assert res.indices.dtype == np.int64 and res.indices.max() > 2 ** 31
        assert_same_join(res.distances, res.indices, want.distances,
                         want.indices)


@pytest.mark.parametrize("reducer", ["dense", "pruned", "gather"])
def test_overfetch_escalation_stays_exact(reducer):
    """Deleting the 20 nearest rows of one query makes the first pass's
    k + min(dead, k) prefix provably incomplete for it: it re-runs at
    k + dead, in both packages alike."""
    rng = np.random.default_rng(8)
    cfg_j, cfg = _configs(k=4, n_pivots=12, n_groups=3, seed=2,
                          reducer=reducer)
    s, r = _data(rng, 250), _data(rng, 10)
    mj = JMutable.build(s, cfg_j)
    mt = rt.MutableIndex.build(s, cfg, device="cpu")
    top20 = rt.knn_join(r[:1], k=20, config=cfg, index=mt,
                        device="cpu").indices[0]
    mt.delete(top20)
    mj.delete(top20)
    res = _check(mt, r, cfg)
    assert not np.isin(res.indices, top20).any()
    assert res.stats.n_tombstones == 20
    want = jknn_join(r, config=cfg_j, index=mj)
    assert_same_join(res.distances, res.indices, want.distances,
                     want.indices)
    mega = rt.knn_join(r, config=cfg, index=mt, megastep=True, device="cpu")
    np.testing.assert_array_equal(mega.distances, res.distances)


def test_segment_t_s_widening_matches_jax():
    """``Segment.index_for_k`` widens T_S by re-summarizing the stored
    assignment: the same pow2 width and lists as the JAX package's."""
    rng = np.random.default_rng(4)
    cfg_j, cfg = _configs(k=3, n_pivots=8, n_groups=2, seed=0)
    s = _data(rng, 90)
    mj = JMutable.build(s, cfg_j)
    mt = rt.MutableIndex.build(s, cfg, device="cpu")
    wj = mj.segments[0].index_for_k(11).t_s.knn_dists
    wt = mt.segments[0].index_for_k(11).t_s.knn_dists.numpy()
    assert wt.shape == wj.shape == (8, 16)
    # the lists hold each package's assignment distances: d² within
    # 2⁻¹⁸ of the largest ‖s‖²+‖p‖² (they sum the expansion in
    # different orders)
    assert_d_close(wt, wj, s)
    assert mt.segments[0].index_for_k(12) is mt.segments[0].index_for_k(11)


def test_delete_and_k_errors():
    rng = np.random.default_rng(4)
    cfg = rt.JoinConfig(k=4, n_pivots=4, n_groups=2)
    mi = rt.MutableIndex.build(_data(rng, 30), cfg, device="cpu")
    for bad in ([30], [-1], [3, 3]):
        with pytest.raises(ValueError):
            mi.delete(bad)
    mi.delete([7])
    with pytest.raises(ValueError, match="already deleted"):
        mi.delete([7])
    mi.delete(np.arange(8, 30))
    assert mi.n_s == 7
    q = _data(rng, 2)
    with pytest.raises(ValueError, match="live"):
        rt.knn_join(q, k=8, config=cfg, index=mi, device="cpu")
    with pytest.raises(ValueError, match="rows but the mutable index"):
        rt.knn_join(q, _data(rng, 9), config=cfg, index=mi, device="cpu")
    res = rt.knn_join(q, k=7, config=cfg, index=mi, device="cpu")
    assert (res.indices >= 0).all()


def test_empty_after_full_delete_compact_and_stats():
    rng = np.random.default_rng(6)
    cfg = rt.JoinConfig(k=2, n_pivots=4, n_groups=2)
    mi = rt.MutableIndex.build(_data(rng, 10), cfg, device="cpu")
    mi.delete(np.arange(10))
    stats = rt.JoinStats()
    mi.compact(stats=stats)
    assert mi.n_s == 0 and mi.n_segments == 0
    assert stats.compact_time_s > 0.0 and mi.last_compact_s == \
        stats.compact_time_s
    np.testing.assert_array_equal(mi.insert(_data(rng, 5)), np.arange(5))
    res = rt.knn_join(_data(rng, 3), k=2, config=cfg, index=mi,
                      device="cpu")
    assert (res.indices >= 0).all()


def test_payload_upload_fault_caches_nothing():
    """An armed ``megastep.payload_upload`` failure raises out of the
    first batch and leaves no payload cached; the retry builds it and
    answers exactly."""
    mi, cfg, r = _mutated(3)
    eng = rt.MegastepEngine(mi, cfg, device="cpu")
    with faultinject.FaultPlan().fail("megastep.payload_upload") as plan:
        with pytest.raises(faultinject.InjectedFault):
            eng.join_batch(r)
        assert eng._payload is None
        d, i = eng.join_batch(r)
    assert plan.fired["megastep.payload_upload"] == 2
    od, oi = _oracle(mi, r, cfg)
    np.testing.assert_array_equal(d, od)
    np.testing.assert_array_equal(i, oi)
    with faultinject.FaultPlan().fail("megastep.fetch"):
        with pytest.raises(faultinject.InjectedFault):
            eng.join_batch(r)


@pytest.mark.parametrize("resident", [True, False])
def test_eps_inflation_forces_fallbacks_output_unchanged(resident):
    """Deflated certified bounds (what an inflated ε would do) fail every
    certificate: all queries fall back through the segments' host route,
    and the output does not change."""
    mi, cfg, r = _mutated(4)
    cfg = dataclasses.replace(cfg, quant_slack=20)
    eng = rt.QuantMegastepEngine(mi, cfg, resident=resident, device="cpu")
    base = eng.join_batch(r)
    stats = rt.JoinStats()
    with faultinject.FaultPlan().transform("quant.eps_inflation",
                                           lambda lb: lb - 1e9):
        d, i = eng.join_batch(r, stats=stats)
    assert stats.n_quant_fallback == r.shape[0]
    np.testing.assert_array_equal(d, base[0])
    np.testing.assert_array_equal(i, base[1])
    od, oi = _oracle(mi, r, cfg)
    np.testing.assert_array_equal(d, od)


def test_nbytes_and_live_device_views():
    mi, cfg, _ = _mutated(5, quantize="int8")
    fp32 = sum(si.n_s for si, _ in mi.segment_snapshot()) * mi.dim * 4
    assert mi.nbytes_resident(quantized=False) == fp32
    assert mi.nbytes_resident() < fp32                 # int8 codes
    rows, gids = mi.live_device_rows()
    rows_c, center, gids_c = mi.live_device_centered()
    want_rows, want_ids = mi.live_rows()
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    np.testing.assert_array_equal(gids, want_ids)
    torch.testing.assert_close(rows_c + center, rows)
    assert mi.live_device_rows()[0] is rows            # cached per version
    mi.delete([int(want_ids[0])])
    assert mi.live_device_rows()[0].shape[0] == rows.shape[0] - 1
