"""The shapes the port's kernels used to refuse (rows wider than 128, a
host-route over-fetch past 64), through the plain versions and every
route, against the JAX package, whose kernels never had those caps.

Tolerance: joins as in ``torch_parity.assert_same_join`` — distances
within 4 ulp of the JAX package's (XLA contracts the canonical chain
into FMAs; ROADMAP Queue C1), ids equal except among those ties; the
plain versions' distances within 2⁻¹⁸ of the largest squared norm sum
(``torch_parity.assert_d_close``: both sum the expanded d² in their own
order). Inside the port the routes stay bitwise equal to each other."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro.core import JoinConfig as JConfig  # noqa: E402
from repro.core import MutableIndex as JMutable  # noqa: E402
from repro.core import knn_join as jknn_join  # noqa: E402
from repro.core import knn_join_batched as jknn_join_batched  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import assign as ka  # noqa: E402
from repro_torch.kernels import distance_topk as kg  # noqa: E402

from torch_parity import assert_d_close, assert_same_join  # noqa: E402

WIDE = 160


def _data(n_s=1500, n_r=120, dim=WIDE, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_s, dim)).astype(np.float32),
            rng.normal(size=(n_r, dim)).astype(np.float32))


def test_plain_versions_at_d160_match_jax():
    """K-A's and K-G's plain versions at d = 160 against the JAX jnp
    references (the Pallas kernels' oracles)."""
    s, r = _data()
    pid, dist = ka.assign_plain(torch.from_numpy(s), torch.from_numpy(r[:24]))
    jpid, jdist = ref.assign_ref(jnp.asarray(s), jnp.asarray(r[:24]))
    assert (pid.numpy() == np.asarray(jpid)).mean() > 0.99
    assert_d_close(dist.numpy(), np.asarray(jdist), np.concatenate([s, r]))
    bm, bn, k = 32, 128, 100
    nr_t, ns_t = -(-r.shape[0] // bm), -(-s.shape[0] // bn)
    rng = np.random.default_rng(1)
    sched = np.zeros((nr_t, ns_t), np.int32)
    counts = rng.integers(1, ns_t + 1, nr_t).astype(np.int32)
    for t in range(nr_t):
        picks = np.sort(rng.choice(ns_t, counts[t], replace=False))
        sched[t, :counts[t]], sched[t, counts[t]:] = picks, picks[-1]
    d, i = kg.distance_topk_gather_plain(
        torch.from_numpy(r), torch.from_numpy(s), k, torch.from_numpy(sched),
        torch.from_numpy(counts), bm=bm, bn=bn)
    jd, ji = ref.distance_topk_gather_ref(
        jnp.asarray(r), jnp.asarray(s), k, jnp.asarray(sched),
        jnp.asarray(counts), bm=bm, bn=bn)
    assert_d_close(d.numpy(), np.asarray(jd), np.concatenate([s, r]))
    assert (i.numpy() == np.asarray(ji)).mean() > 0.99


@pytest.mark.parametrize("route", ["gather", "megastep", "quantized"])
def test_routes_at_d160_match_jax(route):
    """The host route (gather reducer), the megastep and the int8 tier at
    d = 160: each within 4 ulp of the JAX package's, and bitwise equal to
    the port's host route."""
    s, r = _data()
    kw = dict(k=10, n_pivots=24, n_groups=4, reducer="gather", seed=3,
              tile_r=32, tile_s=128)
    if route == "quantized":
        kw["quant_slack"] = 118
    cfg, jcfg = rt.JoinConfig(**kw), JConfig(**kw)
    host = rt.knn_join(r, s, config=cfg, device="cpu")
    if route == "gather":
        got = host
        want = jknn_join(r, s, config=jcfg)
    else:
        got = rt.knn_join_batched(r, s, config=cfg, batch_size=64,
                                  megastep=route == "megastep",
                                  quantized=route == "quantized",
                                  device="cpu")
        want = jknn_join_batched(r, s, config=jcfg, batch_size=64,
                                 megastep=route == "megastep",
                                 quantized=route == "quantized")
        np.testing.assert_array_equal(got.distances, host.distances)
    assert_same_join(got.distances, got.indices, want.distances,
                     want.indices)
    bd, bi = rt.brute_force_knn(r, s, 10, device="cpu")
    assert_same_join(got.distances, got.indices, bd, bi)


def test_host_route_overfetch_past_64_matches_jax():
    """Deleting the 80 nearest rows of a query makes the first pass's
    k + min(dead, k) prefix incomplete for it: the host route re-fetches
    that segment at k + 80 = 90 rows through the gather reducer (past the
    64 the card's K-G used to take), in both packages alike; the megastep
    and the int8 tier give the same bits."""
    s, r = _data(n_s=1200, n_r=40, dim=12, seed=4)
    kw = dict(k=10, n_pivots=16, n_groups=3, seed=2, reducer="gather",
              quant_slack=118)
    cfg, jcfg = rt.JoinConfig(**kw), JConfig(**kw)
    mt = rt.MutableIndex.build(s, cfg, device="cpu")
    mj = JMutable.build(s, jcfg)
    top80 = rt.knn_join(r[:1], k=80, config=cfg, index=mt,
                        device="cpu").indices[0]
    mt.delete(top80)
    mj.delete(top80)
    seg = mt.segments[0]
    fetched = []
    orig = seg.index_for_k

    def spy(m):
        fetched.append(m)
        return orig(m)

    seg.index_for_k = spy
    host = rt.knn_join(r, config=cfg, index=mt, device="cpu")
    assert max(fetched) == 90 and not np.isin(host.indices, top80).any()
    want = jknn_join(r, config=jcfg, index=mj)
    assert_same_join(host.distances, host.indices, want.distances,
                     want.indices)
    for kwargs in ({"megastep": True}, {"quantized": True}):
        got = rt.knn_join_batched(r, index=mt, config=cfg, batch_size=16,
                                  device="cpu", **kwargs)
        np.testing.assert_array_equal(got.distances, host.distances)
    rows, gids = mt.live_rows()
    bd, bi = rt.brute_force_knn(r, rows, 10, device="cpu")
    np.testing.assert_array_equal(host.distances, bd)
