"""The whole slice, port vs JAX package: one index built by the JAX
package and carried across (``sindex_from_arrays``), served by the
port's ``knn_join_batched(megastep=True)`` on the CPU (the kernels'
plain versions) and by the JAX package's megastep, both held against
the JAX brute-force oracle. Plus the port's own invariants: batched ==
one batch bitwise, no host sync inside the steady-state call, the
carried-state merge, and bucketing."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import JoinConfig as JConfig  # noqa: E402
from repro.core import brute_force_knn as j_brute  # noqa: E402
from repro.core import build_index as j_build_index  # noqa: E402
from repro.core import knn_join_batched as j_batched  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.core import MegastepEngine, StreamJoinState  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# XLA contracts the JAX chain's multiply-adds into FMAs; the port's
# eager chain rounds each op — 1–3 ulp apart (ROADMAP Queue C1)
ULP_BOUND = 4


def _ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _data(kind, n_s=2500, n_r=300, dim=8, seed=0):
    if kind == "forest":
        return (rt.forest_like(n_s, 10, seed=seed),
                rt.forest_like(n_r, 10, seed=seed + 1))
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_s, dim)).astype(np.float32),
            rng.normal(size=(n_r, dim)).astype(np.float32))


def _arrays(jidx):
    return {"pivots": jidx.pivots, "pivd": jidx.pivd, "s_part": jidx.s_part,
            "s_dist": jidx.s_dist, "t_s.counts": jidx.t_s.counts,
            "t_s.lower": jidx.t_s.lower, "t_s.upper": jidx.t_s.upper,
            "t_s.knn_dists": jidx.t_s.knn_dists, "s_order": jidx.s_order,
            "s_sorted": jidx.s_sorted, "s_part_sorted": jidx.s_part_sorted,
            "s_dist_sorted": jidx.s_dist_sorted,
            "s_ids_sorted": jidx.s_ids_sorted, "s_inv": jidx.s_inv}


CFG = dict(k=10, n_pivots=24, tile_r=32, tile_s=64)


@pytest.mark.parametrize("kind", ["gaussian", "forest"])
def test_slice_matches_jax_megastep_and_brute_force(kind):
    s, r = _data(kind)
    jidx = j_build_index(s, JConfig(**CFG))
    tidx = rt.sindex_from_arrays(_arrays(jidx), rt.JoinConfig(**CFG),
                                 device="cpu")
    ops.reset_launch_counts()
    got = rt.knn_join_batched(r, index=tidx, batch_size=128, megastep=True,
                              device="cpu")
    assert set(ops.launch_counts().values()) == {0}
    want = j_batched(r, index=jidx, batch_size=128, megastep=True)
    bd, bi = j_brute(r, s, CFG["k"])
    assert got.indices.dtype == np.int64 and got.distances.dtype == np.float32
    assert got.stats.n_batches == 3 and got.stats.n_r == r.shape[0]
    for ref_d, ref_i in ((want.distances, want.indices), (bd, bi)):
        assert _ulps(got.distances, ref_d).max() <= ULP_BOUND
        # ids equal except among tied distances
        mism = got.indices != ref_i
        assert (_ulps(got.distances[mism], ref_d[mism]) <= ULP_BOUND).all()
        if kind == "gaussian":
            assert not mism.any()


@pytest.mark.parametrize("splits", [(1,), (37, 64, 199), (128, 128, 44)])
def test_batched_equals_one_batch_bitwise(splits):
    s, r = _data("gaussian", seed=3)
    idx = rt.build_index(s, rt.JoinConfig(**CFG), device="cpu")
    one = rt.knn_join_batched(r, index=idx, megastep=True, device="cpu")
    cuts = np.cumsum(splits)[:-1] if len(splits) > 1 else []
    parts = np.split(r, cuts) if len(splits) > 1 else [r]
    many = rt.knn_join_batched(iter(parts), index=idx, megastep=True,
                               device="cpu")
    np.testing.assert_array_equal(many.distances, one.distances)
    np.testing.assert_array_equal(many.indices, one.indices)


def test_port_index_joins_exactly():
    """The port's own build_index (K-A's plain version) + megastep vs
    the port's float64 oracle: the same canonical bits."""
    s, r = _data("forest", n_s=3000, n_r=200, seed=5)
    cfg = rt.JoinConfig(k=7, n_pivots=32, tile_r=32, tile_s=64)
    res = rt.knn_join_batched(r, s, config=cfg, batch_size=64, megastep=True,
                              device="cpu")
    bd, bi = rt.brute_force_knn(r, s, 7, device="cpu")
    np.testing.assert_array_equal(res.distances, bd)
    mism = res.indices != bi
    np.testing.assert_array_equal(res.distances[mism], bd[mism])
    assert res.stats.pivot_pairs_computed == 3000 * 32 + 200 * 32


def test_join_batch_device_makes_no_host_sync(monkeypatch):
    """Between enqueue and fetch nothing reads a tensor back to the
    host: the CPU stand-in for set_sync_debug_mode("error") on the card
    is to make every tensor→Python conversion raise."""
    s, r = _data("gaussian", seed=6)
    eng = MegastepEngine(rt.build_index(s, rt.JoinConfig(**CFG),
                                        device="cpu"), device="cpu")
    q, n = eng.enqueue(r[:100])
    warm = eng.join_batch_device(q, n)

    def boom(*a, **k):
        raise AssertionError("host sync inside join_batch_device")
    for name in ("item", "tolist", "__bool__", "__int__", "__float__",
                 "__index__", "numpy", "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    monkeypatch.setattr(torch, "nonzero", boom)
    out = eng.join_batch_device(q, n)
    monkeypatch.undo()
    assert torch.equal(out[0], warm[0]) and torch.equal(out[1], warm[1])
    assert eng.step_count == 2


def test_carried_state_merge_dedups():
    """Revisiting the same queries merges with the carried run: every
    row appears once, so the result is unchanged."""
    s, r = _data("gaussian", seed=7)
    eng = MegastepEngine(rt.build_index(s, rt.JoinConfig(**CFG),
                                        device="cpu"), device="cpu")
    q, n = eng.enqueue(r[:50])
    d0, i0 = eng.join_batch_device(q, n)
    d1, i1 = eng.join_batch_device(q, n, state=(d0, i0))
    assert torch.equal(d1, d0) and torch.equal(i1, i0)


def test_buckets_are_powers_of_two():
    s, r = _data("gaussian", seed=8)
    eng = MegastepEngine(rt.build_index(s, rt.JoinConfig(**CFG),
                                        device="cpu"), device="cpu")
    for n, bucket in ((1, 16), (16, 16), (17, 32), (100, 128)):
        q, nv = eng.enqueue(r[:n])
        assert (q.shape[0], nv) == (bucket, n)
        d, i = eng.finalize(eng.dispatch(r[:n]))
        assert d.shape == (n, CFG["k"]) and i.dtype == np.int64
    d, i = eng.join_batch(r[:0])
    assert d.shape == (0, CFG["k"])


def test_stream_engine_dispatch_finalize_is_join_batch():
    s, r = _data("gaussian", seed=9)
    eng = rt.StreamJoinEngine(rt.build_index(s, rt.JoinConfig(**CFG),
                                             device="cpu"), megastep=True,
                              device="cpu")
    stats = rt.JoinStats()
    d0, i0 = eng.join_batch(r[:70], stats=stats)
    d1, i1 = eng.finalize(eng.dispatch(r[:70], stats=stats))
    np.testing.assert_array_equal(d1, d0)
    np.testing.assert_array_equal(i1, i0)
    assert (stats.n_batches, stats.n_r) == (2, 140)
    assert eng.megastep_engine.step_count == 2


def test_as_float32_rows_casts_floats_and_rejects_the_rest():
    from repro_torch.core import as_float32_rows
    x = torch.arange(6, dtype=torch.bfloat16).reshape(3, 2)
    out = as_float32_rows(x)
    assert out.dtype == torch.float32 and out.is_contiguous()
    assert as_float32_rows(np.ones((2, 2), np.float64)).dtype == torch.float32
    with pytest.raises(TypeError, match="floating point"):
        as_float32_rows(np.ones((2, 2), np.int32))


def test_stream_state_revisit_keeps_each_row_once():
    st = StreamJoinState(n=3, k=4)
    st.update(np.arange(3), np.tile(np.float32([1, 2, 3, 4]), (3, 1)),
              np.tile(np.int64([10, 11, 12, 13]), (3, 1)))
    st.update(np.array([1]), np.float32([[0.5, 2, 2.5, 9]]),
              np.int64([[20, 11, 21, 22]]))
    np.testing.assert_array_equal(st.indices[1], [20, 10, 11, 21])
    np.testing.assert_array_equal(st.distances[1], [0.5, 1, 2, 2.5])
    np.testing.assert_array_equal(st.indices[0], [10, 11, 12, 13])
