"""The port's sharded megastep (``repro_torch.core.sharded``) and its
shard packing, on simulated CPU shards (an explicit device list), against
the port's single-device engines and the JAX package's sharded megastep.

Tolerances: inside the port, the sharded engines give the single-device
engine's distances bit for bit, and its ids too on these Gaussian rows
(no ties); across the packages, distances within 4 ulp (ROADMAP C1) and
ids equal except among tied distances. The shard packing is host numpy
and equals the JAX package's exactly.

The JAX side of the multi-shard comparison needs 8 forced host devices,
so it runs once, in a subprocess behind a module-scoped fixture, at a
tiny size; it writes every reference array to one ``.npz``.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch as rt  # noqa: E402
from repro_torch.core import MegastepEngine, StreamJoinEngine  # noqa: E402
from repro_torch.core.sharded import ShardedMegastepEngine  # noqa: E402
from repro_torch.distributed import make_mesh  # noqa: E402
from repro_torch.kernels.sorted_merge import tree_merge_runs  # noqa: E402
from repro_torch.quant.engine import (QuantMegastepEngine,  # noqa: E402
                                      ShardedQuantMegastepEngine)

from torch_parity import assert_same_join, index_arrays  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
DIM = 5


def _mesh(n):
    return make_mesh((n,), ("shard",), devices=["cpu"] * n)


def _data(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, DIM)).astype(np.float32) * 2).copy()


def _cfg(**kw):
    return rt.JoinConfig(k=5, n_pivots=24, n_groups=6, grouping="geometric",
                         tile_r=16, tile_s=32, **kw)


@pytest.fixture(scope="module")
def small():
    s, r = _data(400, 0), _data(200, 1)
    cfg = _cfg()
    idx = rt.build_index(s, cfg, device="cpu")
    d, i = MegastepEngine(idx, cfg, device="cpu").join_batch(r)
    return s, r, cfg, idx, d, i


# ------------------------------------------------------------ shard packing

@pytest.mark.parametrize("n_shards,r", [(1, 1), (2, 1), (3, 1), (8, 1),
                                         (64, 1), (4, 2), (4, 3), (2, 5)])
def test_shard_packing_equals_jax(n_shards, r):
    """The port's ShardPacking of an index carried across from the JAX
    package is the JAX one, field for field (64 shards > 24 pivots
    exercises the clamp)."""
    from repro.core import JoinConfig as JConfig
    from repro.core import build_index as jbuild
    s = _data(400, 0)
    jidx = jbuild(s, JConfig(k=5, n_pivots=24, n_groups=6,
                             grouping="geometric", tile_s=32))
    idx = rt.sindex_from_arrays(index_arrays(jidx), _cfg(), device="cpu")
    a, b = jidx.shard_packing(n_shards, r=r), idx.shard_packing(n_shards, r=r)
    for f in ("shard_of_part", "rows", "gids_local", "part", "dist",
              "rows_per_shard", "sd_min", "sd_max", "present",
              "replicas_of_part"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (a.tiles_per_shard, a.r) == (b.tiles_per_shard, b.r)
    for x, y in zip(a.ensure_quant(), b.ensure_quant()):
        assert np.array_equal(x, y)
    for failed in ((), (0,), (1, 2)):
        assert np.array_equal(a.owner_view(failed), b.owner_view(failed))
    assert jidx.nbytes_resident(n_shards=n_shards) == \
        idx.nbytes_resident(n_shards=n_shards)


def test_shard_packing_conserves_rows(small):
    _, _, _, idx, _, _ = small
    for n in (1, 2, 3, 8):
        sp = idx.shard_packing(n)
        assert int(sp.rows_per_shard.sum()) == idx.n_s
        gids = sp.gids_local[sp.gids_local >= 0]
        assert np.array_equal(np.sort(gids), np.arange(idx.n_s))
        for j in range(n):
            live = sp.gids_local[j] >= 0
            order = np.lexsort((sp.dist[j][live], sp.part[j][live]))
            assert np.array_equal(order, np.arange(order.size))
    assert idx.nbytes_resident(n_shards=4) == int(
        idx.shard_packing(4).nbytes_per_shard().max())


# ------------------------------------------------------- shard invariance

@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_sharded_fp32_bitwise_single_device(small, n):
    _, r, cfg, idx, d0, i0 = small
    eng = ShardedMegastepEngine(idx, cfg, mesh=_mesh(n))
    d, i = eng.join_batch(r)
    assert np.array_equal(d, d0) and np.array_equal(i, i0)
    # every batch split too, through the streaming entry point
    res = rt.knn_join_batched(r, index=idx, batch_size=37, megastep=True,
                              mesh=_mesh(n), device="cpu")
    assert np.array_equal(res.distances, d0)
    assert np.array_equal(res.indices, i0)
    assert res.stats.n_shards == n and res.stats.n_r == r.shape[0]


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_sharded_int8_bitwise_single_device(n):
    s, r = _data(400, 0), _data(200, 1)
    cfg = _cfg(quantize="int8", quant_slack=11)
    idx = rt.build_index(s, cfg, quantize="int8", device="cpu")
    st0 = rt.JoinStats()
    d0, i0 = QuantMegastepEngine(idx, cfg, device="cpu").join_batch(
        r, stats=st0)
    eng = ShardedQuantMegastepEngine(idx, cfg, mesh=_mesh(n))
    st = rt.JoinStats()
    d, i = eng.join_batch(r, stats=st)
    assert np.array_equal(d, d0) and np.array_equal(i, i0)
    assert st.quant_mode == "int8" and st.n_shards == n
    assert st.n_resident_rerank == r.shape[0]
    d1, i1, rb = eng.join_batch_approx(r)
    assert ((rb >= 0) & (rb <= 1)).all()
    with pytest.raises(NotImplementedError, match="single-device"):
        eng.coarse_shortlist(r)


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_mutable_index_bitwise(n):
    """Over a MutableIndex (base, sealed deltas, a write buffer,
    tombstones): the sharded megastep gives the single-device bits."""
    s, r = _data(600, 2), _data(120, 3)
    cfg = _cfg()
    mi = rt.MutableIndex.build(s[:400], cfg, seal_threshold=64,
                               device="cpu")
    mi.insert(s[400:])
    mi.delete(np.arange(0, 600, 9))
    d0, i0 = MegastepEngine(mi, cfg, device="cpu").join_batch(r)
    d, i = ShardedMegastepEngine(mi, cfg, mesh=_mesh(n)).join_batch(r)
    assert np.array_equal(d, d0) and np.array_equal(i, i0)


def test_tree_merge_is_order_free_and_subset_stable():
    """The id-disjoint fold: any order of the runs gives the same merged
    run, and any subset gives the top-kp of that subset's rows."""
    g = torch.Generator().manual_seed(0)
    kp, n = 8, 5
    ids = torch.randperm(200, generator=g)[:n * kp].reshape(n, 1, kp)
    d = torch.randint(0, 6, (n, 1, kp), generator=g).float()  # many ties
    d, o = torch.sort(d, dim=-1, stable=True)
    ids = torch.take_along_dim(ids, o, dim=-1)
    runs = [(d[j], ids[j]) for j in range(n)]
    ref = tree_merge_runs(runs)
    for perm in ([4, 3, 2, 1, 0], [2, 0, 4, 1, 3]):
        got = tree_merge_runs([runs[j] for j in perm])
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    for sub in ([0, 2], [1, 3, 4]):
        got = tree_merge_runs([runs[j] for j in sub])
        cd = torch.cat([d[j] for j in sub], -1)
        ci = torch.cat([ids[j] for j in sub], -1)
        key = cd * 1000 + ci.float()
        want = torch.sort(key, dim=-1).values[..., :kp]
        assert torch.equal(got[0] * 1000 + got[1].float(), want)
    # unique=True folds runs that share ids: each row once, at its smaller
    # distance
    a = (torch.tensor([[1.0, 2.0, 5.0, 9.0]]), torch.tensor([[7, 3, 4, 8]]))
    b = (torch.tensor([[1.5, 2.0, 3.0, 9.5]]), torch.tensor([[3, 9, 7, 2]]))
    d, i = tree_merge_runs([a, b], unique=True)
    assert i.tolist() == [[7, 3, 9, 4]]
    assert d.tolist() == [[1.0, 1.5, 2.0, 5.0]]


# ----------------------------------------------- the JAX sharded megastep

_JAX_SCRIPT = """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    from repro.core import JoinConfig, build_index
    from repro.core.sharded import ShardedMegastepEngine
    from repro.quant.engine import ShardedQuantMegastepEngine

    def data(n, seed):
        rng = np.random.default_rng(seed)
        return (rng.normal(size=(n, 5)).astype(np.float32) * 2).copy()

    s, r = data(400, 0), data(200, 1)
    out = {}
    cfg = JoinConfig(k=5, n_pivots=24, n_groups=6, grouping="geometric",
                     tile_r=16, tile_s=32)
    idx = build_index(s, cfg)
    out["d"], out["i"] = ShardedMegastepEngine(idx, cfg,
                                               n_shards=8).join_batch(r)
    qcfg = JoinConfig(k=5, n_pivots=24, n_groups=6, grouping="geometric",
                      tile_r=16, tile_s=32, quantize="int8", quant_slack=11)
    qidx = build_index(s, qcfg)
    out["qd"], out["qi"] = ShardedQuantMegastepEngine(
        qidx, qcfg, n_shards=8).join_batch(r)
    for name, x in (("idx", idx), ("qidx", qidx)):
        for f in ("pivots", "pivd", "s_part", "s_dist", "s_order",
                  "s_sorted", "s_part_sorted", "s_dist_sorted",
                  "s_ids_sorted", "s_inv"):
            out[f"{name}.{f}"] = getattr(x, f)
        for f in ("counts", "lower", "upper", "knn_dists"):
            out[f"{name}.t_s.{f}"] = getattr(x.t_s, f)
    qr = qidx.ensure_quant(32)
    out["qidx.quant.q"], out["qidx.quant.scales"] = qr.q, qr.scales
    out["qidx.quant.eps"] = qr.eps
    np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_sharded") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT), str(path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


def _carried(ref, name, cfg):
    arrays = {key[len(name) + 1:]: v for key, v in ref.items()
              if key.startswith(name + ".")}
    return rt.sindex_from_arrays(arrays, cfg, device="cpu")


@pytest.mark.parametrize("n", [1, 8])
def test_sharded_fp32_matches_jax(jax_ref, n):
    """The JAX sharded megastep (8 devices) against the port's (1 and 8
    simulated shards) over the same index."""
    cfg = _cfg()
    idx = _carried(jax_ref, "idx", cfg)
    r = _data(200, 1)
    d, i = ShardedMegastepEngine(idx, cfg, mesh=_mesh(n)).join_batch(r)
    assert_same_join(d, i, jax_ref["d"], jax_ref["i"])


def test_sharded_int8_matches_jax(jax_ref):
    cfg = _cfg(quantize="int8", quant_slack=11)
    idx = _carried(jax_ref, "qidx", cfg)
    r = _data(200, 1)
    d, i = ShardedQuantMegastepEngine(idx, cfg, mesh=_mesh(8)).join_batch(r)
    assert_same_join(d, i, jax_ref["qd"], jax_ref["qi"])


# --------------------------------------------------- wiring and validation

def test_stream_and_batched_wiring(small):
    _, r, cfg, idx, d0, i0 = small
    eng = StreamJoinEngine(idx, cfg, megastep=True, mesh=_mesh(2),
                           device="cpu")
    assert isinstance(eng.megastep_engine, ShardedMegastepEngine)
    assert eng.megastep_engine.n_shards == 2
    h = eng.dispatch(r)
    d, i = eng.finalize(h)
    assert np.array_equal(d, d0) and np.array_equal(i, i0)
    with pytest.raises(ValueError, match="megastep-mode"):
        StreamJoinEngine(idx, cfg, mesh=_mesh(2), device="cpu")
    with pytest.raises(ValueError, match="sharded-engine knobs"):
        StreamJoinEngine(idx, cfg, megastep=True, replication=2,
                         device="cpu")
    with pytest.raises(ValueError, match="disagrees"):
        ShardedMegastepEngine(idx, cfg, n_shards=3, mesh=_mesh(2))


def test_datastore_wiring():
    from repro_torch.serve import Datastore
    keys = _data(500, 4)
    vals = np.arange(500) % 11
    q = _data(40, 5)
    one = Datastore.build(keys, vals, k=4, n_pivots=16, device="cpu")
    sh = Datastore.build(keys, vals, k=4, n_pivots=16, n_shards=3,
                         mesh=_mesh(3), device="cpu")
    d0, i0, v0 = one.retrieve(q)
    d1, i1, v1 = sh.retrieve(q)
    assert np.array_equal(d0, d1) and np.array_equal(i0, i1)
    assert isinstance(sh.engine().megastep_engine, ShardedMegastepEngine)
    # mutations reach the sharded payload through the index version
    for store in (one, sh):
        store.add_entries(_data(30, 6), np.zeros(30))
        store.remove_entries(np.arange(0, 500, 7))
    d0, i0, _ = one.retrieve(q)
    d1, i1, _ = sh.retrieve(q)
    assert np.array_equal(d0, d1) and np.array_equal(i0, i1)
    assert sh.recover_shards(wait=True) == []


def test_more_shards_than_devices_raises(small, monkeypatch):
    """Without an explicit device list, a mesh takes the present cards:
    more shards than cards raise, no card at all raises, and an index on
    the CPU takes its one CPU; nothing puts N shards on one device."""
    _, r, cfg, idx, _, _ = small
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((2,), ("shard",))
    with monkeypatch.context() as m:          # a host with one card
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="explicit device list"):
            make_mesh((2,), ("shard",))
    assert ShardedMegastepEngine(idx, cfg, device="cpu").mesh.devices \
        == [torch.device("cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedMegastepEngine(idx, cfg, n_shards=2)
    with pytest.raises(ValueError, match="explicit device list"):
        ShardedMegastepEngine(idx, cfg, n_shards=2, device="cpu")
    with pytest.raises(ValueError, match="explicit device list"):
        rt.knn_join_batched(r, index=idx, megastep=True, n_shards=2,
                            device="cpu")
    assert _mesh(4).size == 4
    with pytest.raises(ValueError, match="1-D mesh"):
        ShardedMegastepEngine(idx, cfg, mesh=make_mesh(
            (2, 2), ("a", "b"), devices=["cpu"] * 4))


def test_quant_sharded_is_resident_only(small, monkeypatch):
    import repro_torch.quant.engine as qe
    s, _, _, _, _, _ = small
    cfg = _cfg(quantize="int8", quant_slack=11)
    idx = rt.build_index(s, cfg, quantize="int8", device="cpu")
    monkeypatch.setattr(qe, "_RESIDENT_MAX_BYTES", 1)
    with pytest.raises(ValueError, match="resident-only"):
        ShardedQuantMegastepEngine(idx, cfg, mesh=_mesh(2))
    with pytest.raises(ValueError, match="does not replicate"):
        StreamJoinEngine(idx, cfg, quantized=True, mesh=_mesh(2),
                         replication=2, device="cpu")


def test_nbytes_per_shard_and_stats(small):
    _, r, cfg, idx, _, _ = small
    eng = ShardedMegastepEngine(idx, cfg, mesh=_mesh(3), replication=2)
    per = eng.nbytes_per_shard()
    assert int(per.sum()) == 2 * idx.nbytes_resident()
    st = rt.JoinStats()
    eng.join_batch(r, stats=st)
    assert (st.n_shards, st.n_failed_shards, st.n_r) == (3, 0, r.shape[0])
    assert st.coverage_bound == 1.0 and st.recall_bound == 1.0
