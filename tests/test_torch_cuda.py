"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no NVIDIA GPU is present (the
kernels have no CPU mode). On a machine with a card run
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``;
``python3 chip_smoke.py`` does the same at the serving path's real
shapes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch as rt  # noqa: E402
from repro_torch.kernels import assign as ka  # noqa: E402
from repro_torch.kernels import distance_topk as kg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,m,dim", [(1000, 16, 6), (2570, 300, 12),
                                     (64, 7, 40)])
def test_assign_kernel_matches_plain(cuda, n, m, dim):
    rng = np.random.default_rng(n)
    x = torch.as_tensor(rng.normal(size=(n, dim)).astype(np.float32),
                        device=cuda)
    p = torch.as_tensor(rng.normal(size=(m, dim)).astype(np.float32),
                        device=cuda)
    pid, dist = ka.assign_cuda(x, p)
    rpid, rdist = ka.assign_plain(x, p)
    assert (pid == rpid).float().mean() > 0.999
    torch.testing.assert_close(dist, rdist, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("k,dim,dead", [(5, 6, 0.0), (16, 12, 0.3),
                                        (10, 70, 0.9)])
def test_gather_kernel_matches_plain(cuda, k, dim, dead):
    rng = np.random.default_rng(k)
    nr, ns, bm, bn = 200, 1500, 32, 128
    r = torch.as_tensor(rng.normal(size=(nr, dim)).astype(np.float32),
                        device=cuda)
    s = torch.as_tensor(rng.normal(size=(ns, dim)).astype(np.float32),
                        device=cuda)
    alive = torch.as_tensor((rng.random(ns) >= dead).astype(np.float32),
                            device=cuda)
    nr_t, ns_t = -(-nr // bm), -(-ns // bn)
    counts = rng.integers(1, ns_t + 1, nr_t)
    sched = np.zeros((nr_t, ns_t), np.int32)
    for t in range(nr_t):
        picks = np.sort(rng.choice(ns_t, counts[t], replace=False))
        sched[t, :counts[t]], sched[t, counts[t]:] = picks, picks[-1]
    sched = torch.as_tensor(sched, device=cuda)
    counts = torch.as_tensor(counts.astype(np.int32), device=cuda)
    d, i = kg.distance_topk_gather_cuda(r, s, k, sched, counts, alive=alive,
                                        bm=bm, bn=bn)
    rd, ri = kg.distance_topk_gather_plain(r, s, k, sched, counts,
                                           alive=alive, bm=bm, bn=bn)
    fin = torch.isfinite(rd)
    assert torch.equal(torch.isfinite(d), fin)
    torch.testing.assert_close(d[fin], rd[fin], atol=1e-4, rtol=1e-5)
    assert (i == ri)[fin].float().mean() > 0.999
    assert bool((i[~fin] == -1).all())


def test_canonical_chain_is_the_same_bits_on_cpu_and_card(cuda):
    from repro_torch.core.metrics import canonical_gathered
    rng = np.random.default_rng(1)
    q = torch.from_numpy((rng.normal(size=(300, 10)) * 300).astype(np.float32))
    nb = torch.from_numpy((rng.normal(size=(300, 16, 10)) * 300)
                          .astype(np.float32))
    assert torch.equal(canonical_gathered(q.to(cuda), nb.to(cuda)).cpu(),
                       canonical_gathered(q, nb))


def test_megastep_on_the_card_is_exact(cuda):
    s = rt.forest_like(20000, 10, seed=0)
    r = rt.forest_like(3000, 10, seed=1)
    cfg = rt.JoinConfig(k=10, n_pivots=64, tile_r=128, tile_s=512)
    ops.reset_launch_counts()
    got = rt.knn_join_batched(r, s, config=cfg, batch_size=1024,
                              megastep=True, device=cuda)
    counts = ops.launch_counts()
    assert counts["assign"] == 1 and counts["distance_topk_gather"] == 3
    bd, bi = rt.brute_force_knn(r, s, 10, device=cuda)
    np.testing.assert_array_equal(got.distances, bd)


def _quant_case(rng, n_r, n_s, dim, bm, bn, dead, scale=3.0, offset=0.0):
    """Codes, scales, ε and a schedule for the coarse kernel, from numpy."""
    from repro_torch.quant import quantize_queries_np, quantize_rows
    s = (rng.normal(size=(n_s, dim)) * scale + offset).astype(np.float32)
    q = (rng.normal(size=(n_r, dim)) * scale + offset).astype(np.float32)
    qr = quantize_rows(s, bn)
    qi, qsc, qe = quantize_queries_np(q)
    ns_t = qr.n_tiles
    alive = (np.arange(ns_t * bn) < n_s) & (rng.random(ns_t * bn) >= dead)
    d_true = np.sqrt(((q[:, None].astype(np.float64) - s[None]) ** 2).sum(-1))
    theta = np.quantile(d_true, 0.2, axis=1).astype(np.float32)
    nr_t = -(-n_r // bm)
    counts = rng.integers(1, ns_t + 1, nr_t)
    sched = np.zeros((nr_t, ns_t), np.int32)
    for t in range(nr_t):
        picks = np.sort(rng.choice(ns_t, counts[t], replace=False))
        sched[t, :counts[t]], sched[t, counts[t]:] = picks, picks[-1]
    return [torch.from_numpy(x) for x in (
        qi, qsc, qe, theta, qr.q, qr.scales, qr.eps,
        alive.astype(np.float32), sched, counts.astype(np.int32))]


@pytest.mark.parametrize("mp,dim,dead,offset", [
    (16, 10, 0.0, 0.0), (128, 10, 0.05, 500.0), (64, 33, 0.3, 0.0),
    (512, 4, 0.0, -20.0)])
def test_quant_coarse_kernel_matches_plain(cuda, mp, dim, dead, offset):
    """K-Q against its plain version: lb bit-equal, positions equal."""
    from repro_torch.kernels import quant_topk as kq
    rng = np.random.default_rng(mp + dim)
    bm, bn = 32, 128
    args = [t.to(cuda) for t in _quant_case(rng, 300, 2000, dim, bm, bn,
                                            dead, offset=offset)]
    sched, counts = args[8], args[9]
    lb, pos = kq.quant_coarse_gather_cuda(*args[:8], mp, sched, counts,
                                          bm=bm, bn=bn)
    rlb, rpos = kq.quant_coarse_sched_plain(*args[:8], mp, sched, counts,
                                            bm=bm, bn=bn)
    torch.cuda.synchronize()
    assert torch.equal(lb.view(torch.int32), rlb.view(torch.int32))
    assert torch.equal(pos, rpos)
    assert bool(torch.isfinite(lb).any())


def test_quant_path_cpu_equals_card(cuda):
    """The quantized tier on the card (K-Q, resident re-rank, fallbacks
    through the host path's K-G) and on the CPU (plain versions): the
    same canonical distances, both exact. θ and the schedule come from
    float32 matrix products summed in another order on each device, so
    the shortlists themselves may differ at the prune boundary."""
    s = rt.forest_like(20000, 10, seed=0)
    r = rt.forest_like(2000, 10, seed=1)
    cfg = rt.JoinConfig(k=10, n_pivots=64, tile_r=128, tile_s=512,
                        quant_slack=118, reducer="gather")
    out = {}
    for dev in ("cpu", cuda):
        idx = rt.build_index(s, cfg, quantize="int8", device=dev)
        eng = rt.QuantMegastepEngine(idx, cfg, device=dev)
        ops.reset_launch_counts()
        stats = rt.JoinStats()
        d, i = eng.join_batch(r, stats=stats)
        out[str(dev)] = (d, i, stats, ops.launch_counts())
    d_c, i_c, st_c, n_c = out["cpu"]
    d_g, i_g, st_g, n_g = out[str(cuda)]
    np.testing.assert_array_equal(d_c, d_g)
    np.testing.assert_array_equal(d_c[i_c != i_g], d_g[i_c != i_g])
    assert set(n_c.values()) == {0} and n_g["quant_coarse_gather"] == 1
    assert st_g.n_quant_fallback == 0 or n_g["distance_topk_gather"] > 0
    bd, _ = rt.brute_force_knn(r, s, 10, device=cuda)
    np.testing.assert_array_equal(d_g, bd)


def test_host_path_on_the_card_is_exact(cuda):
    s = rt.forest_like(20000, 10, seed=0)
    r = rt.forest_like(3000, 10, seed=1)
    ops.reset_launch_counts()
    res = rt.knn_join(r, s, config=rt.JoinConfig(
        k=10, n_pivots=64, n_groups=4, reducer="gather"), device=cuda)
    counts = ops.launch_counts()
    assert counts["assign"] == 2 and 1 <= counts["distance_topk_gather"] <= 4
    bd, _ = rt.brute_force_knn(r, s, 10, device=cuda)
    np.testing.assert_array_equal(res.distances, bd)


@pytest.mark.parametrize("d,k,masked", [(10, 10, False), (10, 10, True),
                                        (1024, 8, True), (1024, 64, False)])
def test_dense_kernel_matches_plain(cuda, d, k, masked):
    """K-D against its plain version: empty slots equal, d² within each
    pair's fp32 limit (both sum the expanded form in their own order:
    (2d+4)·2⁻²⁴·(‖r‖²+‖s‖²) each, plus the √ rounding), ids equal
    except where the two d² tie within it."""
    from repro_torch.kernels import distance_topk as kd
    rng = np.random.default_rng(d + k)
    nr, ns, bm, bn = 300, 5000, 128, 512
    r = torch.as_tensor(rng.normal(size=(nr, d)).astype(np.float32),
                        device=cuda)
    s = torch.as_tensor(rng.normal(size=(ns, d)).astype(np.float32),
                        device=cuda)
    mask = None
    if masked:
        mask = torch.as_tensor((rng.random((-(-nr // bm), -(-ns // bn)))
                                < 0.5).astype(np.int8), device=cuda)
    ops.reset_launch_counts()
    dk, ik = kd.distance_topk_cuda(r, s, k, visit_mask=mask, bm=bm, bn=bn)
    dp, ip = kd.distance_topk_plain(r, s, k, visit_mask=mask, bm=bm, bn=bn)
    assert ops.launch_counts()["distance_topk"] == 1
    full = ip >= 0
    assert torch.equal(ik >= 0, full)
    r64, s64 = r.double(), s.double()
    s2 = (s64 * s64).sum(1)
    ikc, ipc = ik.long().clamp(min=0), ip.long().clamp(min=0)
    tol = ((r64 * r64).sum(1)[:, None] + torch.maximum(s2[ikc], s2[ipc])) \
        * 2 * (2 * d + 8) * 2.0 ** -24
    d2k, d2p = dk.double() ** 2, dp.double() ** 2
    assert bool(((d2k - d2p).abs() <= tol)[full].all())
    ex_k = ((r64[:, None, :] - s64[ikc]) ** 2).sum(-1)
    assert bool((((ex_k - d2p).abs() <= 1.5 * tol) | (ik == ip))[full].all())


def test_multi_segment_megastep_cpu_equals_card(cuda):
    """A mutable index with sealed deltas, a write buffer and tombstones:
    the megastep over its 4 segments gives the same distances on the CPU
    (plain versions) and on the card (K-A, K-G), both exact, and the
    card's step makes no host sync."""
    s = rt.forest_like(20000, 10, seed=0)
    r = rt.forest_like(3000, 10, seed=1)
    cfg = rt.JoinConfig(k=10, n_pivots=64, tile_r=128, tile_s=512)
    out = {}
    for dev in ("cpu", cuda):
        mi = rt.MutableIndex.build(s[:16000], cfg, seal_threshold=1500,
                                   device=dev)
        for lo, hi in ((16000, 17500), (17500, 19000), (19000, 20000)):
            mi.insert(s[lo:hi])
        mi.delete(np.arange(0, 20000, 97))
        assert (len(mi.segments), mi.n_buffered) == (3, 1000)
        ops.reset_launch_counts()
        res = rt.knn_join_batched(r, index=mi, batch_size=1024,
                                  megastep=True, device=dev)
        out[str(dev)] = (res, ops.launch_counts(), mi)
    (rc, nc, _), (rg, ng, mi) = out["cpu"], out[str(cuda)]
    np.testing.assert_array_equal(rc.distances, rg.distances)
    assert set(nc.values()) == {0} and ng["distance_topk_gather"] == 3
    assert rg.stats.n_segments == 4 and rg.stats.n_tombstones == 207
    rows, gids = mi.live_rows()
    bd, _ = rt.brute_force_knn(r, rows, 10, device=cuda)
    np.testing.assert_array_equal(rg.distances, bd)
    eng = rt.MegastepEngine(mi, cfg, device=cuda)
    qd, nv = eng.enqueue(r[:1024])
    eng.join_batch_device(qd, nv)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.join_batch_device(qd, nv)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_retrieval_routes_on_the_card(cuda):
    """Both ``knn_logits`` routes on the card (K-G through the megastep,
    K-D over the centered live rows) across a mutation: the join route
    exact; K-D's d² within the fp32 limit of the expanded form on the
    centered rows (δ = 2(2d+8)·2⁻²⁴·(‖q_c‖² + max‖s_c‖²)); the
    log-probabilities within 4δ/τ + 2⁻¹⁵ where the id sets agree."""
    from repro_torch.serve import Datastore, KnnLMConfig, knn_logits
    rng = np.random.default_rng(5)
    keys = rt.forest_like(30000, 10, seed=2)
    vals = rng.integers(0, 7, 31000).astype(np.int32)
    store = Datastore.build(keys, vals[:30000], k=10, n_pivots=64,
                            device=cuda)
    q = rt.forest_like(500, 10, seed=3)
    d0, _, _ = store.retrieve(q, 10)
    kcfg = KnnLMConfig(k=10, tau=float(np.median(d0[:, -1] ** 2)))
    for step in range(2):
        ops.reset_launch_counts()
        lj, (dj, ij) = knn_logits(q, store, kcfg, 7, return_neighbors=True)
        lk, (dk, ik) = knn_logits(q, store, kcfg, 7, use_kernel=True,
                                  return_neighbors=True)
        counts = ops.launch_counts()
        assert counts["distance_topk"] == 1 and \
            counts["distance_topk_gather"] >= 1
        rows, gids = store.index.live_rows()
        bd, bi = rt.brute_force_knn(q, rows, 10, device=cuda)
        np.testing.assert_array_equal(dj, bd)
        rows_c, center, _ = store.index.live_device_centered()
        qc = (torch.as_tensor(q, device=cuda) - center).double()
        delta = (2 * (2 * 10 + 8) * 2.0 ** -24
                 * ((qc * qc).sum(1) + float((rows_c.double() ** 2)
                                             .sum(1).max()))).cpu().numpy()
        err = np.abs(dk.astype(np.float64) ** 2 - dj.astype(np.float64) ** 2)
        assert (err <= delta[:, None]).all()
        same = (np.sort(ij, 1) == np.sort(ik, 1)).all(1)
        assert same.mean() > 0.9
        lp_tol = 4 * float(delta.max()) / kcfg.tau + 2.0 ** -15
        assert np.abs(lk[same] - lj[same]).max() <= lp_tol
        store.add_entries(rt.forest_like(1000, 10, seed=4 + step),
                          vals[30000:])
        store.remove_entries(np.arange(step, 30000, 101))


# ---- the lifted caps: any d for K-A / K-G / K-Q, any k for K-G / K-D,
# any power-of-two mp for K-Q


def test_assign_kernel_any_width(cuda):
    """K-A past d = 128 (the wide kernel) against its plain version: the
    same d² chain limit as K-G's, ids equal but at near-ties."""
    rng = np.random.default_rng(3)
    n, m, dim = 3000, 70, 300
    x = torch.as_tensor(rng.normal(size=(n, dim)).astype(np.float32),
                        device=cuda)
    p = torch.as_tensor(rng.normal(size=(m, dim)).astype(np.float32),
                        device=cuda)
    pid, dist = ka.assign_cuda(x, p)
    rpid, rdist = ka.assign_plain(x, p)
    assert (pid == rpid).float().mean() > 0.999
    x64, p64 = x.double(), p.double()
    tol = ((x64 * x64).sum(1) + (p64 * p64).sum(1).max()) \
        * 2 * (2 * dim + 8) * 2.0 ** -24
    assert bool(((dist.double() ** 2 - rdist.double() ** 2).abs()
                 <= tol).all())


def _gather_case(cuda, rng, nr, ns, dim, bm, bn, dead):
    r = torch.as_tensor(rng.normal(size=(nr, dim)).astype(np.float32),
                        device=cuda)
    s = torch.as_tensor(rng.normal(size=(ns, dim)).astype(np.float32),
                        device=cuda)
    alive = torch.as_tensor((rng.random(ns) >= dead).astype(np.float32),
                            device=cuda)
    nr_t, ns_t = -(-nr // bm), -(-ns // bn)
    counts = rng.integers(1, ns_t + 1, nr_t)
    sched = np.zeros((nr_t, ns_t), np.int32)
    for t in range(nr_t):
        picks = np.sort(rng.choice(ns_t, counts[t], replace=False))
        sched[t, :counts[t]], sched[t, counts[t]:] = picks, picks[-1]
    return (r, s, torch.as_tensor(sched, device=cuda),
            torch.as_tensor(counts.astype(np.int32), device=cuda), alive)


@pytest.mark.parametrize("k,dim", [(100, 10), (10, 160), (300, 200)])
def test_gather_kernel_any_width_and_k(cuda, k, dim):
    """K-G's general kernel (past d = 128 or k = 64) against the plain
    version, as the register kernel's test holds it."""
    rng = np.random.default_rng(k + dim)
    bm, bn = 32, 128
    r, s, sched, counts, alive = _gather_case(cuda, rng, 150, 3000, dim,
                                              bm, bn, 0.2)
    d, i = kg.distance_topk_gather_cuda(r, s, k, sched, counts, alive=alive,
                                        bm=bm, bn=bn)
    rd, ri = kg.distance_topk_gather_plain(r, s, k, sched, counts,
                                           alive=alive, bm=bm, bn=bn)
    fin = torch.isfinite(rd)
    assert torch.equal(torch.isfinite(d), fin)
    torch.testing.assert_close(d[fin], rd[fin], atol=1e-4, rtol=1e-5)
    assert (i == ri)[fin].float().mean() > 0.999
    assert bool((i[~fin] == -1).all())


def test_gather_general_kernel_equals_register_kernel(cuda):
    """The general kernel computes the register kernel's d² chain: its
    first 64 entries at k = 65 are the register kernel's k = 64 run, bit
    for bit."""
    rng = np.random.default_rng(9)
    r, s, sched, counts, alive = _gather_case(cuda, rng, 200, 4000, 12, 32,
                                              128, 0.1)
    d64, i64 = kg.distance_topk_gather_cuda(r, s, 64, sched, counts,
                                            alive=alive, bm=32, bn=128)
    d65, i65 = kg.distance_topk_gather_cuda(r, s, 65, sched, counts,
                                            alive=alive, bm=32, bn=128)
    assert torch.equal(d65[:, :64], d64) and torch.equal(i65[:, :64], i64)


@pytest.mark.parametrize("k,dim", [(10, 6), (8, 32), (40, 70), (64, 128),
                                   (100, 10), (10, 160)])
def test_gather_kernel_split_counts_bitwise(cuda, k, dim):
    """K-G's schedule split: 1 split, 3 and the planner's count give the
    same bits and positions, in the register kernel and the general one
    (past d = 128 or k = 64), on rows with duplicates (ties)."""
    rng = np.random.default_rng(k * dim)
    r, s, sched, counts, alive = _gather_case(cuda, rng, 200, 6000, dim, 32,
                                              128, 0.2)
    s[3000:] = s[:3000].clone()
    kw = dict(alive=alive, bm=32, bn=128)
    outs = []
    for sp in (1, 3, None):
        outs.append(kg.distance_topk_gather_cuda(r, s, k, sched, counts,
                                                 splits=sp, **kw))
        assert kg.last_plan == kg.plan_gather(200, dim, k, 32,
                                              sched.shape[1], splits=sp)
    assert kg.last_plan.splits > 1
    for d_, i_ in outs[1:]:
        assert torch.equal(d_.view(torch.int32), outs[0][0].view(torch.int32))
        assert torch.equal(i_, outs[0][1])
    rd, ri = kg.distance_topk_gather_plain(r, s, k, sched, counts, **kw)
    fin = torch.isfinite(rd)
    torch.testing.assert_close(outs[2][0][fin], rd[fin], atol=1e-4,
                               rtol=1e-5)


def test_gather_kernel_decode_batch(cuda):
    """K-G at a kNN-LM decode step, scaled down: 8 queries, one R tile,
    a schedule of 96 tiles split across blocks, against the plain
    version (d 32, k 8)."""
    rng = np.random.default_rng(32)
    bm, bn, n_tiles = 128, 512, 96
    r = torch.as_tensor(rng.normal(size=(8, 32)).astype(np.float32),
                        device=cuda)
    s = torch.as_tensor(rng.normal(size=(bn * n_tiles - 100, 32))
                        .astype(np.float32), device=cuda)
    sched = torch.arange(n_tiles, dtype=torch.int32, device=cuda)[None, :]
    counts = torch.tensor([n_tiles], dtype=torch.int32, device=cuda)
    d, i = kg.distance_topk_gather_cuda(r, s, 8, sched, counts, bm=bm, bn=bn)
    assert kg.last_plan.splits > 1
    rd, ri = kg.distance_topk_gather_plain(r, s, 8, sched, counts, bm=bm,
                                           bn=bn)
    torch.testing.assert_close(d, rd, atol=1e-4, rtol=1e-5)
    assert (i == ri).float().mean() > 0.99


@pytest.mark.parametrize("k,masked", [(128, False), (100, True)])
def test_dense_kernel_wide_k(cuda, k, masked):
    """K-D past k = 64 (wide runs) against its plain version, and its
    first 64 entries at k = 65 bitwise the register runs' k = 64."""
    from repro_torch.kernels import distance_topk as kd
    rng = np.random.default_rng(k)
    nr, ns, bm, bn, dim = 300, 20000, 128, 512, 10
    r = torch.as_tensor(rng.normal(size=(nr, dim)).astype(np.float32),
                        device=cuda)
    s = torch.as_tensor(rng.normal(size=(ns, dim)).astype(np.float32),
                        device=cuda)
    mask = None
    if masked:
        mask = torch.as_tensor((rng.random((-(-nr // bm), -(-ns // bn)))
                                < 0.5).astype(np.int8), device=cuda)
    kw = dict(visit_mask=mask, bm=bm, bn=bn)
    dk, ik = kd.distance_topk_cuda(r, s, k, **kw)
    dp, ip = kd.distance_topk_plain(r, s, k, **kw)
    full = ip >= 0
    assert torch.equal(ik >= 0, full)
    r64, s64 = r.double(), s.double()
    s2 = (s64 * s64).sum(1)
    ikc, ipc = ik.long().clamp(min=0), ip.long().clamp(min=0)
    tol = ((r64 * r64).sum(1)[:, None] + torch.maximum(s2[ikc], s2[ipc])) \
        * 2 * (2 * dim + 8) * 2.0 ** -24
    assert bool(((dk.double() ** 2 - dp.double() ** 2).abs()
                 <= tol)[full].all())
    d64, i64 = kd.distance_topk_cuda(r, s, 64, **kw)
    d65, i65 = kd.distance_topk_cuda(r, s, 65, **kw)
    assert torch.equal(d65[:, :64], d64) and torch.equal(i65[:, :64], i64)


@pytest.mark.parametrize("mp,dim", [(1024, 10), (64, 160), (1024, 300)])
def test_quant_coarse_kernel_any_width_and_mp(cuda, mp, dim):
    """K-Q's general kernel (past d = 128 or mp = 512) against its plain
    version: lb bit-equal, positions equal."""
    from repro_torch.kernels import quant_topk as kq
    rng = np.random.default_rng(mp + dim)
    bm, bn = 32, 128
    args = [t.to(cuda) for t in _quant_case(rng, 100, 3000, dim, bm, bn,
                                            0.1)]
    sched, counts = args[8], args[9]
    lb, pos = kq.quant_coarse_gather_cuda(*args[:8], mp, sched, counts,
                                          bm=bm, bn=bn)
    rlb, rpos = kq.quant_coarse_sched_plain(*args[:8], mp, sched, counts,
                                            bm=bm, bn=bn)
    torch.cuda.synchronize()
    assert torch.equal(lb.view(torch.int32), rlb.view(torch.int32))
    assert torch.equal(pos, rpos)
    assert bool(torch.isfinite(lb).any())


# ---- K-F, the flash attention kernel


def _attn_inputs(cuda, rng, b, nq, nk, h, kvh, d, dtype, cache_len=None):
    q = torch.as_tensor(rng.normal(size=(b, nq, h, d)).astype(np.float32),
                        device=cuda).to(dtype)
    c = nk if cache_len is None else cache_len
    kc = torch.as_tensor(rng.normal(size=(b, c, kvh, d)).astype(np.float32),
                         device=cuda).to(dtype)
    vc = torch.as_tensor(rng.normal(size=(b, c, kvh, d)).astype(np.float32),
                         device=cuda).to(dtype)
    return q, kc[:, :nk], vc[:, :nk]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 80, 128, 192, 320])
@pytest.mark.parametrize("case", ["causal", "window", "decode", "no_key",
                                  "prefill_1024", "decode_4096"])
def test_flash_attention_kernel_matches_plain(cuda, dtype, d, case):
    """K-F against its plain version, at any head width (80, 192 and 320
    are not instantiated widths). k and v are live slices of a longer
    cache (read in place through their strides). fp32: within 2e-5 abs
    (the dot products and sums run in another order); bf16: within one
    bf16 rounding of the output (2⁻⁷ relative) — both versions compute
    in fp32 and round once. ``no_key``: rows right-aligned before the
    first key see nothing and come out 0. ``prefill_1024`` runs bf16 up
    to d = 256 through the tensor-core form; ``decode_4096`` splits the
    keys across blocks (split-KV and the combine pass)."""
    from repro_torch.kernels import flash_attention as kf
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(d)
    shapes = {"causal": (2, 300, 300, 6, 2, None),
              "window": (2, 300, 300, 4, 4, 50),
              "decode": (3, 1, 333, 6, 2, None),
              "no_key": (2, 20, 7, 4, 1, None),
              "prefill_1024": (2, 1024, 1024, 4, 2, None),
              "decode_4096": (2, 1, 4096, 6, 2, None)}
    b, nq, nk, h, kvh, window = shapes[case]
    q, k, v = _attn_inputs(cuda, rng, b, nq, nk, h, kvh, d, dt,
                           cache_len=nk + 40)
    assert not k.is_contiguous()
    ops.reset_launch_counts()
    out = kf.flash_attention_cuda(q, k, v, causal=True, window=window)
    if case == "prefill_1024" and dt == torch.bfloat16 and d <= 256:
        assert kf.last_plan.route == "mma"
    if case == "decode_4096":
        assert kf.last_plan.route == "simt" and kf.last_plan.splits > 1
    ref = kf.flash_attention_plain(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    assert out.dtype == dt and out.shape == (b, nq, h, d)
    a, r = out.float(), ref.float()
    if dt == torch.float32:
        assert float((a - r).abs().max()) <= 2e-5
    else:
        lim = 2.0 ** -7 * torch.maximum(a.abs(), r.abs()) + 1e-6
        assert bool(((a - r).abs() <= lim).all())
    if case == "no_key":
        assert bool((out[:, :nq - nk] == 0).all())
        assert bool((out[:, nq - nk:] != 0).any())
