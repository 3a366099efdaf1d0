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


def _pair_tol(a2, b2, d):
    """chip_smoke.py's limit on |d²_kernel − d²_plain| for rows with
    squared norms a2, b2: each version's expanded fp32 sum is off the
    exact d² by at most (2d + 4)·u·(a2 + b2), its √ output rounds d² by 4u
    more (u = 2⁻²⁴); the limit is the sum of both bounds."""
    return (a2 + b2) * (2 * (2 * d + 8)) * 2.0 ** -24


def _assign_near_ties(x, p, pid, dist, ref_pid):
    """K-A's ids equal ``ref_pid`` except at near-ties: where they differ,
    both picks' exact d² (float64) lie within the pair's limit of each
    other; and every distance's d² within the limit of its pick's exact
    d²."""
    x64, p64 = x.double(), p.double()
    x2, p2 = (x64 * x64).sum(1), (p64 * p64).sum(1)
    a, b = pid.long(), ref_pid.long()
    assert bool(((a >= 0) & (a < p.shape[0])).all())
    rows = torch.arange(x.shape[0], device=x.device)
    ex = x2[:, None] + p2[None, :] - 2.0 * (x64 @ p64.T)
    tol = _pair_tol(x2, torch.maximum(p2[a], p2[b]), x.shape[1])
    assert bool(((ex[rows, a] - ex[rows, b]).abs() <= tol).all())
    assert bool(((dist.double() ** 2 - ex[rows, a]).abs() <= tol).all())


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
    _assign_near_ties(x, p, pid, dist, rpid)
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
    _assign_near_ties(x, p, pid, dist, rpid)
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


# ---- K-D's two forms and K-Q's whole-tile blocks and screen


def _dense_check(cuda, r, s, k, dk, ik, dp, ip):
    """A K-D run against the plain version's: empty slots equal, d²
    within each pair's fp32 limit, ids equal except at near-ties."""
    d = r.shape[1]
    full = ip >= 0
    assert torch.equal(ik >= 0, full)
    r64, s64 = r.double(), s.double()
    s2 = (s64 * s64).sum(1)
    ikc, ipc = ik.long().clamp(min=0), ip.long().clamp(min=0)
    tol = ((r64 * r64).sum(1)[:, None] + torch.maximum(s2[ikc], s2[ipc])) \
        * 2 * (2 * d + 8) * 2.0 ** -24
    assert bool(((dk.double() ** 2 - dp.double() ** 2).abs()
                 <= tol)[full].all())
    ex_k = ((r64[:, None, :] - s64[ikc]) ** 2).sum(-1)
    assert bool((((ex_k - dp.double() ** 2).abs() <= 1.5 * tol)
                 | (ik == ip))[full].all())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [1, 8, 10, 64, 65, 128])
@pytest.mark.parametrize("d", [1, 10, 32, 33, 1024])
def test_dense_forms_match_plain(cuda, d, k, masked):
    """K-D on either side of its form cut (d = 32 narrow, 33 tile; k = 64
    narrow, 65 tile), ragged n_r and n_s, against the plain version; the
    plan the launch used is the planner's."""
    from repro_torch.kernels import distance_topk as kd
    rng = np.random.default_rng(1000 * d + k)
    nr, ns, bm, bn = 301, 4999, 128, 512
    r = torch.as_tensor(rng.normal(size=(nr, d)).astype(np.float32),
                        device=cuda)
    s = torch.as_tensor(rng.normal(size=(ns, d)).astype(np.float32),
                        device=cuda)
    s[4000:4100] = s[:100]                     # duplicate rows: ties
    mask = None
    if masked:
        mask = torch.as_tensor((rng.random((-(-nr // bm), -(-ns // bn)))
                                < 0.5).astype(np.int8), device=cuda)
    kw = dict(visit_mask=mask, bm=bm, bn=bn)
    dk, ik = kd.distance_topk_cuda(r, s, k, **kw)
    plan = kd.last_dense_plan
    assert plan == kd.plan_dense(nr, ns, d, k, bm, bn)
    assert plan.form == ("narrow" if d <= 32 and k <= 64 else "tile")
    dp, ip = kd.distance_topk_plain(r, s, k, **kw)
    torch.cuda.synchronize()
    _dense_check(cuda, r, s, k, dk, ik, dp, ip)


@pytest.mark.parametrize("d,k", [(10, 10), (32, 64), (4, 1)])
def test_dense_forms_and_splits_are_bitwise_equal(cuda, d, k):
    """Both forms sum the same fp32 chains (dot, ‖q‖², ‖s‖² ascending), so
    the narrow and tile forms, at any split count, give the same bits."""
    from repro_torch.kernels import distance_topk as kd
    rng = np.random.default_rng(d + k)
    r = torch.as_tensor(rng.normal(size=(200, d)).astype(np.float32),
                        device=cuda)
    s = torch.as_tensor(rng.normal(size=(6000, d)).astype(np.float32),
                        device=cuda)
    ref = kd.distance_topk_cuda(r, s, k, form="narrow", splits=1)
    for form in ("narrow", "tile"):
        for splits in (1, 3, 12):
            got = kd.distance_topk_cuda(r, s, k, form=form, splits=splits)
            assert kd.last_dense_plan.splits == splits
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def _quant_at_cut(rng, n_r, n_s, dim, bm, bn, dead):
    """K-Q inputs whose θ are exact lb values (many pairs at the cut),
    rows with duplicates (lb ties), ~``dead`` of the rows dead, and a
    random ascending schedule per R tile."""
    from repro_torch.kernels import quant_topk as kq
    from repro_torch.quant import quantize_queries_np, quantize_rows
    s = (rng.normal(size=(n_s, dim)) * 3.0).astype(np.float32)
    s[n_s // 2:n_s // 2 + 200] = s[:200]
    q = (rng.normal(size=(n_r, dim)) * 3.0).astype(np.float32)
    qr = quantize_rows(s, bn)
    qi, qsc, qe = quantize_queries_np(q)
    ns_t = qr.n_tiles
    alive = (np.arange(ns_t * bn) < n_s) & (rng.random(ns_t * bn) >= dead)
    nr_t = -(-n_r // bm)
    counts = rng.integers(1, ns_t + 1, nr_t)
    sched = np.zeros((nr_t, ns_t), np.int32)
    for t in range(nr_t):
        picks = np.sort(rng.choice(ns_t, counts[t], replace=False))
        sched[t, :counts[t]], sched[t, counts[t]:] = picks, picks[-1]
    args = [torch.from_numpy(x) for x in (
        qi, qsc, qe, np.zeros(n_r, np.float32), qr.q, qr.scales, qr.eps,
        alive.astype(np.float32), sched, counts.astype(np.int32))]
    lb = kq.coarse_lb_tile(args[0], args[1], args[2], args[4],
                           torch.repeat_interleave(args[5], bn), args[6])
    # θ: the exact lb of a random row, so pairs sit at the cut
    pick = torch.as_tensor(rng.integers(0, lb.shape[1], n_r))
    args[3] = lb[torch.arange(n_r), pick].contiguous()
    return args


@pytest.mark.parametrize("mp", [128, 512, 1024])
@pytest.mark.parametrize("dim", [10, 32, 33, 256])
def test_quant_coarse_whole_tile_matches_plain(cuda, dim, mp):
    """K-Q against its plain version with θ at exact lb values: lb bit-
    equal, positions equal; every split count gives the same bits; the
    counter's share of pairs that reached the exact chain is in [0, 1]."""
    from repro_torch.kernels import quant_topk as kq
    rng = np.random.default_rng(7 * dim + mp)
    bm, bn = 128, 512
    args = [t.to(cuda) for t in _quant_at_cut(rng, 300, 40 * 512, dim, bm,
                                              bn, 0.1)]
    sched, counts = args[8], args[9]
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    lb, pos = kq.quant_coarse_gather_cuda(*args[:8], mp, sched, counts,
                                          bm=bm, bn=bn, stats=stats)
    assert kq.last_plan == kq.plan_quant(300, dim, mp, bm, bn,
                                         sched.shape[1])
    rlb, rpos = kq.quant_coarse_sched_plain(*args[:8], mp, sched, counts,
                                            bm=bm, bn=bn)
    torch.cuda.synchronize()
    assert torch.equal(lb.view(torch.int32), rlb.view(torch.int32))
    assert torch.equal(pos, rpos)
    assert bool(torch.isfinite(lb).any())
    live, chain = int(stats[0]), int(stats[1])
    assert 0 < live and 0 <= chain <= live
    for splits in (1, 5):
        got = kq.quant_coarse_gather_cuda(*args[:8], mp, sched, counts,
                                          bm=bm, bn=bn, splits=splits)
        assert kq.last_plan.splits == splits
        assert torch.equal(got[0].view(torch.int32), lb.view(torch.int32))
        assert torch.equal(got[1], pos)


# ---- K-A's two forms and its splits


def _assign_inputs(cuda, n, m, d):
    """Gaussian rows and pivots, the later half of the pivots copies of
    earlier ones (exact ties across every cut), a few rows copies of
    pivots (d² = 0). Returns (x, pivots, the ids that have a lower twin)."""
    rng = np.random.default_rng(n + 10 * m + 1000 * d)
    p = rng.normal(size=(m, d)).astype(np.float32)
    if m > 1:
        p[m // 2:] = p[rng.integers(0, m // 2, m - m // 2)]
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:min(n, 8)] = p[rng.integers(0, m, min(n, 8))]
    twins = [j for j in range(m // 2, m) if (p[:m // 2] == p[j]).all(1).any()]
    return (torch.as_tensor(x, device=cuda), torch.as_tensor(p, device=cuda),
            torch.as_tensor(twins, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("m", [1, 7, 128, 257])
@pytest.mark.parametrize("d", [1, 4, 10, 31, 32, 33, 300, 3072])
def test_assign_forms_splits_and_dense_k1_are_bitwise_equal(cuda, d, m):
    """K-A's forms (both where d <= 32) and every split count give the
    bits of the planner's launch, which are K-D's at k = 1 (the same
    chains); ids equal the float64 argmin but at near-ties, and a
    duplicated pivot never beats its lower twin."""
    from repro_torch.kernels import distance_topk as kd
    for n in (1, 1023, 4097):
        x, p, twins = _assign_inputs(cuda, n, m, d)
        pid, dist = ka.assign_cuda(x, p)
        assert ka.last_assign_plan == ka.plan_assign(n, m, d)
        bits = dist.view(torch.int32)
        for form in (("narrow", "tile") if d <= 32 else ("tile",)):
            for splits in (1, 2, 3, 7, 10 ** 6):
                got_p, got_d = ka.assign_cuda(x, p, form=form, splits=splits)
                assert ka.last_assign_plan == ka.plan_assign(
                    n, m, d, form=form, splits=splits)
                assert torch.equal(got_p, pid)
                assert torch.equal(got_d.view(torch.int32), bits)
        dk, ik = kd.distance_topk_cuda(x, p, 1)
        assert torch.equal(ik[:, 0], pid)
        assert torch.equal(dk[:, 0].view(torch.int32), bits)
        torch.cuda.synchronize()
        x64, p64 = x.double(), p.double()
        ex = ((x64 * x64).sum(1)[:, None] + (p64 * p64).sum(1)[None, :]
              - 2.0 * (x64 @ p64.T))
        _assign_near_ties(x, p, pid, dist, ex.argmin(1))
        assert not bool(torch.isin(pid, twins).any())


@pytest.mark.parametrize("d", [10, 33])
def test_assign_non_finite_rows_take_the_clamp(cuda, d):
    """A NaN d² clamps to 0 in K-A's chain (fmaxf), so a row with a NaN
    coordinate picks pivot 0 at distance 0, and a row with one +inf
    coordinate the first pivot whose coordinate there is >= 0 (its t is
    inf − inf or NaN: clamped to 0; a negative one gives +inf); every form
    and split agrees bit for bit."""
    rng = np.random.default_rng(d)
    p = rng.normal(size=(300, d)).astype(np.float32)
    p[:5, 2] = -1.0                    # pivots 0-4 negative in column 2
    p[7, 2] = 0.0
    x = rng.normal(size=(700, d)).astype(np.float32)
    x[3, 4] = np.nan
    x[10, 2] = np.inf
    x[11, 2], x[11, 4] = np.inf, np.nan
    xt, pt = torch.as_tensor(x, device=cuda), torch.as_tensor(p, device=cuda)
    pid, dist = ka.assign_cuda(xt, pt)
    first = int(np.argmax(p[:, 2] >= 0))
    assert pid[3].item() == 0 and dist[3].item() == 0.0
    assert pid[10].item() == first and dist[10].item() == 0.0
    assert pid[11].item() == 0 and dist[11].item() == 0.0
    fin = np.ones(700, bool)
    fin[[3, 10, 11]] = False
    assert bool(torch.isfinite(dist[torch.as_tensor(fin, device=cuda)]).all())
    for form in (("narrow", "tile") if d <= 32 else ("tile",)):
        for splits in (1, 3, 40):
            got_p, got_d = ka.assign_cuda(xt, pt, form=form, splits=splits)
            assert torch.equal(got_p, pid)
            assert torch.equal(got_d.view(torch.int32), dist.view(torch.int32))


@pytest.mark.parametrize("d", [3, 10, 32, 33])
def test_assign_unaligned_rows_take_the_same_bits(cuda, d):
    """Rows and pivots 4 bytes off a 16-byte boundary (a view into a
    larger buffer) take K-A's 4-byte staging: the same bits as the aligned
    copies, in every form."""
    rng = np.random.default_rng(40 + d)
    n, m = 3000, 70
    flat_x = torch.as_tensor(rng.normal(size=n * d + 1).astype(np.float32),
                             device=cuda)
    flat_p = torch.as_tensor(rng.normal(size=m * d + 1).astype(np.float32),
                             device=cuda)
    x, p = flat_x[1:].view(n, d), flat_p[1:].view(m, d)
    assert x.data_ptr() % 16 and p.data_ptr() % 16 and x.is_contiguous()
    for form in (("narrow", "tile") if d <= 32 else ("tile",)):
        pid, dist = ka.assign_cuda(x, p, form=form)
        ref_p, ref_d = ka.assign_cuda(x.clone(), p.clone(), form=form)
        assert torch.equal(pid, ref_p)
        assert torch.equal(dist.view(torch.int32), ref_d.view(torch.int32))


# ---------------------------------------------------------------------------
# the serving scheduler, the pinned upload and the §6 baselines on the card


def _sched_engine(cuda, quantized, n=3000, dim=10, k=10):
    s = rt.forest_like(n, dim, seed=31)
    cfg = rt.JoinConfig(k=k, n_pivots=32, tile_r=32, tile_s=128,
                        quantize="int8" if quantized else "none",
                        quant_slack=22)
    idx = rt.build_index(s, cfg, device=cuda)
    return rt.StreamJoinEngine(idx, cfg, megastep=True, quantized=quantized,
                               device=cuda), s


@pytest.mark.parametrize("quantized", [False, True])
def test_scheduler_exact_rung_bitwise_engine(cuda, quantized):
    """Through the scheduler, synchronously and with two megasteps in
    flight, every ticket carries the engine's own bits."""
    from repro_torch.serve import SchedulerConfig, ServeScheduler, VirtualClock
    eng, _ = _sched_engine(cuda, quantized)
    qs = [rt.forest_like(n, 10, seed=40 + n) for n in (9, 40, 13, 64, 7)]
    want = [eng.join_batch(q) for q in qs]
    for mi in (1, 2):
        vc = VirtualClock()
        sched = ServeScheduler(eng, config=SchedulerConfig(
            batch_rows=48, max_inflight=mi), clock=vc.now, sleep=vc.advance)
        tickets = [sched.submit(q) for q in qs]
        sched.drain()
        for t, (d, i) in zip(tickets, want):
            assert t.done and not t.degraded
            np.testing.assert_array_equal(t.distances, d)
            np.testing.assert_array_equal(t.indices, i)


@pytest.mark.parametrize("quantized", [False, True])
def test_dispatch_makes_no_host_sync(cuda, quantized):
    eng, _ = _sched_engine(cuda, quantized)
    q = rt.forest_like(256, 10, seed=50)
    want = eng.join_batch(q)                  # warm: payload and staging
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = eng.dispatch(q)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    d, i = eng.finalize(handle)
    np.testing.assert_array_equal(d, want[0])
    np.testing.assert_array_equal(i, want[1])


@pytest.mark.parametrize("quantized", [False, True])
def test_staging_not_reused_while_in_flight(cuda, quantized):
    """Four batches of one bucket dispatched, then finalized in order.
    Each upload's pinned buffer is freed as ``dispatch`` returns, while
    its copy is still queued behind the earlier batches' kernels; the
    caching host allocator must not hand it to the next batch before
    the copy completes, so the bits equal one at a time."""
    eng, _ = _sched_engine(cuda, quantized)
    qs = [rt.forest_like(200 + j, 10, seed=60 + j) for j in range(4)]
    one = [eng.join_batch(q) for q in qs]
    handles = [eng.dispatch(q) for q in qs]
    for (d1, i1), h in zip(one, handles):
        d, i = eng.finalize(h)
        np.testing.assert_array_equal(d, d1)
        np.testing.assert_array_equal(i, i1)


@pytest.mark.parametrize("method", ["hbrj", "pbj"])
@pytest.mark.parametrize("kind", ["forest", "osm"])
def test_baselines_card_equal_cpu(cuda, method, kind):
    x = (rt.forest_like(2500, 10, seed=70) if kind == "forest"
         else rt.osm_like(2500, seed=70))
    run = {"hbrj": lambda dev: rt.hbrj_join(x, x, 8, n_reducers=9,
                                            device=dev),
           "pbj": lambda dev: rt.pbj_join(x, x, 8, rt.JoinConfig(
               k=8, n_pivots=32), n_reducers=9, device=dev)}[method]
    got, want = run(cuda), run("cpu")
    np.testing.assert_array_equal(got.distances, want.distances)
    mism = got.indices != want.indices
    np.testing.assert_array_equal(got.distances[mism],
                                  want.distances[mism])
    bd, _ = rt.brute_force_knn(x, x, 8, device=cuda)
    np.testing.assert_array_equal(got.distances, bd)
    assert got.stats.replicas_s == want.stats.replicas_s
    assert got.stats.pivot_pairs_computed == want.stats.pivot_pairs_computed


@pytest.mark.parametrize("metric", ["l1", "linf"])
def test_metric_oracle_small_tile_same_bits(cuda, metric, monkeypatch):
    """The L1 / L∞ oracle with a difference tile that memory cuts to one
    row or a few gives the default's bits, and the CPU's."""
    from repro_torch.core import baselines as tb
    s = rt.forest_like(4000, 10, seed=80)
    r = rt.forest_like(300, 10, seed=81)
    d0, i0 = rt.brute_force_knn(r, s, 10, metric=metric, device=cuda)
    for cap in (1, 8 * 4000 * 10 * 3):
        monkeypatch.setattr(tb, "DIFF_TILE_BYTES", cap)
        d, i = rt.brute_force_knn(r, s, 10, metric=metric, device=cuda)
        np.testing.assert_array_equal(d, d0)
        np.testing.assert_array_equal(i, i0)
    dc, _ = rt.brute_force_knn(r, s, 10, metric=metric, device="cpu")
    np.testing.assert_array_equal(d0, dc)


# ---- the mesh (shards simulated on the one card from an explicit list)

def _card_mesh(n, name="shard"):
    from repro_torch.distributed import make_mesh
    return make_mesh((n,), (name,), devices=["cuda:0"] * n)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_megastep_on_card(cuda, n):
    """The sharded megastep on ``n`` simulated card shards: K-G once per
    shard a batch, the single-device engine's distances and ids bit for
    bit, on Forest-like rows that hold duplicates and exact ties (ROADMAP
    C17: the k of a certified run are taken in (exact d², id) order)."""
    s = rt.forest_like(20_000, 10, seed=90)
    r = rt.forest_like(1_500, 10, seed=91)
    cfg = rt.JoinConfig(k=10, n_pivots=64)
    idx = rt.build_index(s, cfg, device=cuda)
    want = rt.knn_join_batched(r, index=idx, batch_size=512, megastep=True,
                               device=cuda)
    ops.reset_launch_counts()
    got = rt.knn_join_batched(r, index=idx, batch_size=512, megastep=True,
                              mesh=_card_mesh(n), device=cuda)
    assert ops.launch_counts()["distance_topk_gather"] == \
        n * got.stats.n_batches
    np.testing.assert_array_equal(got.distances, want.distances)
    np.testing.assert_array_equal(got.indices, want.indices)


def test_megastep_card_equals_cpu_at_ties(cuda):
    """C17's rows: the card's megastep (K-G) and the CPU's (K-G's plain
    version) give the same distances and ids, ties included, and both
    are the exact (exact d², id) order over every row."""
    from repro_torch.core.certify import exact_topk
    s = rt.forest_like(20_000, 10, seed=90)
    r = rt.forest_like(1_500, 10, seed=91)
    cfg = rt.JoinConfig(k=10, n_pivots=64)
    got = {}
    for dev in (cuda, "cpu"):
        idx = rt.build_index(s, cfg, device=dev)
        got[str(dev)] = rt.knn_join_batched(r, index=idx, batch_size=512,
                                            megastep=True, device=dev)
    card, cpu = got[str(cuda)], got["cpu"]
    np.testing.assert_array_equal(card.distances, cpu.distances)
    np.testing.assert_array_equal(card.indices, cpu.indices)
    d, i = exact_topk(torch.from_numpy(r), torch.from_numpy(s),
                      torch.arange(s.shape[0]), 10)
    np.testing.assert_array_equal(card.indices, i.numpy())


@pytest.mark.parametrize("route", ["gather", "megastep", "sharded"])
def test_k_g_routes_exact_on_map_coordinates_card(cuda, route):
    """C15 on the card: 16,384 OSM-like rows, every K-G route bitwise the
    float64 oracle (uncertified runs re-run exactly and are counted)."""
    x = rt.osm_like(16_384, seed=16)
    bd, _ = rt.brute_force_knn(x, x, 10, device=cuda)
    cfg = rt.JoinConfig(k=10, n_pivots=128, n_groups=9, reducer="gather")
    if route == "gather":
        res = rt.knn_join(x, x, config=cfg, device=cuda)
    else:
        idx = rt.build_index(x, cfg, device=cuda)
        res = rt.knn_join_batched(
            x, index=idx, batch_size=4096, megastep=True, device=cuda,
            mesh=_card_mesh(4) if route == "sharded" else None)
    np.testing.assert_array_equal(res.distances, bd)
    assert 0 < res.stats.n_exact_rerun < x.shape[0]


def test_moe_routing_card_equals_cpu(cuda):
    """The MoE router on the card picks the CPU's experts, slots and kept
    mask (bfloat16 logits on a grid: every one exact, ties everywhere),
    and the reduced deepseek's MoE FFN agrees across the devices."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import moe
    cfg = configs.get_reduced("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    rng = np.random.default_rng(11)
    w = (rng.integers(-2, 3, (cfg.d_model, cfg.moe.n_experts)) * 0.125
         ).astype(np.float32)
    w[:, 5] = w[:, 2]
    x = (rng.integers(-2, 3, (4100, cfg.d_model)) * 0.25).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        p = {"router": {"w": torch.as_tensor(w, device=dev).bfloat16()}}
        out[str(dev)] = moe.moe_route(
            p, torch.as_tensor(x, device=dev).bfloat16(), cfg)
    for a, b in zip(out["cpu"][:3], out[str(cuda)][:3]):
        assert torch.equal(a, b.cpu())
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32,
                     "cpu")
    xs = torch.as_tensor(rng.normal(size=(2, 40, cfg.d_model)),
                         dtype=torch.float32)
    want = moe.moe_apply(p, xs, cfg)
    def to_card(tree):
        if isinstance(tree, dict):
            return {key: to_card(val) for key, val in tree.items()}
        if isinstance(tree, list):
            return [to_card(val) for val in tree]
        return tree.to(cuda)

    got = moe.moe_apply(to_card(p), xs.to(cuda), cfg).cpu()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("form", ["absorbed", "expanded"])
def test_mla_on_kf_matches_plain(cuda, form):
    """MLA on the card, in bfloat16: with a cache (absorbed, K-F at d =
    kv_lora + rope, v = k) and without (expanded, v padded): K-F launched
    once a call, its output within one bfloat16 rounding of the plain
    version's on the same inputs, and the layer's output too."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.models.layers import mla_apply, mla_cache, mla_init
    cfg = configs.get_arch("deepseek-v2-lite-16b")
    c = cfg.mla
    gen = torch.Generator(device=cuda).manual_seed(3)
    p = mla_init(gen, cfg, torch.bfloat16, cuda)
    x = torch.randn((2, 300, cfg.d_model), generator=gen,
                    device=cuda).bfloat16()
    pos = torch.arange(300, device=cuda)[None].expand(2, 300)

    def cache():
        if form == "expanded":
            return None
        return mla_cache(2, 300, c.kv_lora_rank, c.rope_head_dim,
                         torch.bfloat16, cuda)

    seen = []
    flash = ops.flash_attention

    def checking(q, k, v, **kw):
        out = flash(q, k, v, **kw)
        ref = kf.flash_attention_plain(q, k, v, **kw)
        seen.append(tuple(q.shape))
        lim = 2.0 ** -7 * torch.maximum(out.float().abs(), ref.float().abs())
        assert bool(((out.float() - ref.float()).abs() <= lim + 1e-6).all())
        return out

    ops.reset_launch_counts()
    ops.flash_attention = checking
    try:
        got, _ = mla_apply(p, x, cfg, positions=pos, cache=cache())
    finally:
        ops.flash_attention = flash
    width = (c.kv_lora_rank + c.rope_head_dim if form == "absorbed"
             else c.qk_nope_head_dim + c.rope_head_dim)
    assert seen == [(2, 300, cfg.n_heads, width)]
    assert ops.launch_counts()["flash_attention"] == 1
    ops.flash_attention = kf.flash_attention_plain
    try:
        want, _ = mla_apply(p, x, cfg, positions=pos, cache=cache())
    finally:
        ops.flash_attention = flash
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), want.float(), atol=0.05,
                               rtol=0.05)


def test_sharded_dispatch_makes_no_host_sync(cuda):
    from repro_torch.core.sharded import ShardedMegastepEngine
    s = rt.forest_like(20_000, 10, seed=92)
    q = rt.forest_like(512, 10, seed=93)
    cfg = rt.JoinConfig(k=10, n_pivots=64)
    eng = ShardedMegastepEngine(rt.build_index(s, cfg, device=cuda), cfg,
                                mesh=_card_mesh(4), replication=2)
    want = eng.join_batch(q)
    qd, nv = eng.enqueue(q)
    warm = eng.join_batch_device(qd, nv)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step = eng.join_batch_device(qd, nv)
        handle = eng.dispatch(q)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(torch.equal(a, b) for a, b in zip(step, warm))
    d, i = eng.finalize(handle)
    np.testing.assert_array_equal(d, want[0])
    np.testing.assert_array_equal(i, want[1])


def test_sharded_int8_on_card(cuda):
    from repro_torch.quant.engine import ShardedQuantMegastepEngine
    s = rt.forest_like(20_000, 10, seed=94)
    r = rt.forest_like(1_000, 10, seed=95)
    cfg = rt.JoinConfig(k=10, n_pivots=64, quant_slack=118)
    idx = rt.build_index(s, cfg, quantize="int8", device=cuda)
    want = rt.QuantMegastepEngine(idx, cfg, device=cuda).join_batch(r)
    ops.reset_launch_counts()
    got = ShardedQuantMegastepEngine(idx, cfg,
                                     mesh=_card_mesh(4)).join_batch(r)
    assert ops.launch_counts()["quant_coarse_gather"] >= 4
    np.testing.assert_array_equal(got[0], want[0])


def test_shuffle_join_and_phase1_on_card(cuda):
    """The L2 shuffle reducer runs K-D once a shard, exact against the
    oracle; distributed_phase1 runs K-A once a shard with the bits of
    assign_and_summarize."""
    from repro_torch.core.distributed import (distributed_knn_join,
                                              distributed_phase1)
    from repro_torch.core.partition import assign_and_summarize
    x = rt.forest_like(6_000, 10, seed=96)
    plan = rt.core.plan_join(x, x, rt.JoinConfig(k=10, n_pivots=64,
                                                 n_groups=4), device=cuda)
    ops.reset_launch_counts()
    got = distributed_knn_join(x, x, plan, _card_mesh(4, "data"),
                               reducer="shuffle")
    assert ops.launch_counts()["distance_topk"] == 4
    bd, _ = rt.brute_force_knn(x, x, 10, device=cuda)
    np.testing.assert_array_equal(got.distances, bd)
    piv = plan.index.pivots
    ops.reset_launch_counts()
    p1, d1, t1 = distributed_phase1(x, piv, _card_mesh(4, "data"), k=10)
    assert ops.launch_counts()["assign"] == 4
    p0, d0, t0 = assign_and_summarize(torch.as_tensor(x, device=cuda), piv,
                                      k=10)
    assert torch.equal(p0, p1) and torch.equal(d0, d1)
    assert torch.equal(t0.knn_dists, t1.knn_dists)


# ---- the recurrent, hybrid, audio and VLM families (K-F non-causal, the
# ring decode, M-RoPE)


def _attn_close(out, ref):
    a, r = out.float(), ref.float()
    if out.dtype == torch.float32:
        assert float((a - r).abs().max()) <= 2e-5
    else:
        lim = 2.0 ** -7 * torch.maximum(a.abs(), r.abs()) + 1e-6
        assert bool(((a - r).abs() <= lim).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq", [1500, 64, 1])
def test_flash_attention_non_causal_matches_plain(cuda, dtype, nq):
    """K-F without the causal mask at whisper's shapes (MHA, 12 heads, d =
    64, 1,500 encoder frames): the encoder (nq = nk), cross-attention
    over a prompt and over one decode query (split-KV); within the
    limits of ``test_flash_attention_kernel_matches_plain``."""
    from repro_torch.kernels import flash_attention as kf
    dt = getattr(torch, dtype)
    q, k, v = _attn_inputs(cuda, np.random.default_rng(nq), 2, nq, 1500, 12,
                           12, 64, dt)
    ops.reset_launch_counts()
    out = kf.flash_attention_cuda(q, k, v, causal=False)
    if dt == torch.bfloat16 and nq > 16:
        assert kf.last_plan.route == "mma"
    ref = kf.flash_attention_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    _attn_close(out, ref)
    if 1 < nq < 1500:   # every key is visible: not the causal function
        causal = kf.flash_attention_plain(q, k, v, causal=True)
        assert not torch.equal(ref, causal)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("live", [700, 2048])
def test_flash_attention_ring_decode_d256_mqa(cuda, dtype, live):
    """recurrentgemma's ring decode on K-F: one query of 16 heads over
    the live slots of a 2,048-slot MQA ring (d = 256, read in place),
    every slot visible (non-causal); and its windowed prefill (mma form,
    DV chunks) at window 512."""
    from repro_torch.kernels import flash_attention as kf
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(live)
    q, k, v = _attn_inputs(cuda, rng, 2, 1, live, 16, 1, 256, dt,
                           cache_len=2048)
    out = kf.flash_attention_cuda(q, k, v, causal=False)
    assert kf.last_plan.route == "simt" and kf.last_plan.zc == 2
    _attn_close(out, kf.flash_attention_plain(q, k, v, causal=False))
    q, k, v = _attn_inputs(cuda, rng, 1, live, live, 16, 1, 256, dt)
    out = kf.flash_attention_cuda(q, k, v, window=512)
    if dt == torch.bfloat16:
        assert kf.last_plan.route == "mma" and kf.last_plan.zc == 2
    _attn_close(out, kf.flash_attention_plain(q, k, v, window=512))


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-350m",
                                  "whisper-small", "qwen2-vl-7b"])
def test_reduced_family_card_equals_cpu(cuda, arch):
    """Each reduced family on the card and on the CPU with the same fp32
    weights: train-mode logits, a prefill past recurrentgemma's window
    and decode steps through the ring within 2e-5 + 2e-5·|logit|; greedy
    tokens equal (whisper through ``make_serve_step`` with ``enc_out``,
    qwen2-vl with vision embeddings over (3, B, T) positions)."""
    from repro_torch import configs
    from repro_torch.models import (ModelOptions, encode, forward,
                                    init_cache, init_params)
    cfg = configs.get_reduced(arch)
    opts = ModelOptions(dtype=torch.float32)
    cpu = init_params(cfg, torch.Generator().manual_seed(3), opts,
                      device="cpu")

    def to(tree, dev):
        if isinstance(tree, dict):
            return {key: to(val, dev) for key, val in tree.items()}
        if isinstance(tree, list):
            return [to(val, dev) for val in tree]
        return tree.to(dev)

    card = to(cpu, cuda)
    rng = np.random.default_rng(7)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (3, 90)))
    ex = {}
    if cfg.n_enc_layers:
        ex["enc_frames"] = torch.as_tensor(rng.standard_normal(
            (3, cfg.enc_len, cfg.d_model), dtype=np.float32))
    if cfg.n_vision_embeds:
        ex["vision_embeds"] = torch.as_tensor(rng.standard_normal(
            (3, cfg.n_vision_embeds, cfg.d_model), dtype=np.float32))
    got = {}
    for where, p, dev in (("cpu", cpu, "cpu"), ("card", card, cuda)):
        kw = to(ex, dev)
        if cfg.n_enc_layers:
            kw = {"enc_out": encode(p, cfg, kw.pop("enc_frames"), opts)}
        full, _ = forward(p, cfg, toks.to(dev), opts=opts, **kw)
        cache = init_cache(cfg, 3, 96, opts, device=dev)
        lg, cache = forward(p, cfg, toks[:, :80].to(dev), cache=cache,
                            opts=opts, mode="prefill", **kw)
        steps = [lg]
        kw.pop("vision_embeds", None)
        for t in range(80, 90):
            lg, cache = forward(p, cfg, toks[:, t:t + 1].to(dev),
                                cache=cache, opts=opts, mode="decode", **kw)
            steps.append(lg)
        got[where] = [x.cpu() for x in [full] + steps]
    for a, b in zip(got["card"], got["cpu"]):
        assert bool(((a - b).abs() <= 2e-5 + 2e-5 * b.abs()).all())
        assert torch.equal(a.argmax(-1), b.argmax(-1))


# ---------------------------------------------------------- K-B (training)
def _rel_norm(a, b):
    return float((a.float() - b.float()).norm() / (b.float().norm() + 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    # b, nq, nk, h, kvh, d, causal, window, d_v (v and dO zero past it)
    (2, 64, 64, 4, 2, 16, True, None, None),     # the reduced models' heads
    (2, 96, 80, 6, 2, 64, True, None, None),     # rows that see no key
    (1, 150, 150, 4, 1, 256, True, 40, None),    # windowed, MQA, d 256
    (2, 50, 130, 4, 4, 64, False, None, None),   # cross-attention
    (1, 70, 70, 4, 4, 192, True, None, None),    # MLA's expanded width
    (1, 300, 300, 16, 1, 256, True, None, None),  # MQA: row splits in bf16
    (2, 77, 203, 4, 2, 64, False, None, None),   # ragged nk, nq < nk
    (2, 100, 100, 4, 4, 192, True, None, 128),   # MLA: v padded from 128
    (1, 300, 300, 8, 2, 128, True, 64, None),    # window 64 at T 300
    (1, 40, 40, 4, 2, 20, True, None, None),     # bf16 pads d to 24
])
def test_flash_attention_bwd_matches_plain(cuda, dtype, shape):
    """K-B against its plain version on the same inputs and K-F lse:
    ‖Δ‖ / ‖ref‖ within 1e-5 in float32 and 2⁻⁸ in bf16 (both sum in
    float32 in other orders, then round once to the inputs' type; bf16
    also feeds p and dS to the tensor cores as two bf16 terms, 2⁻¹⁷
    relative); the route the plan gives the dtype (``last_bwd_plan``),
    row splits for MQA in bf16, dv's padded columns exactly 0, and a
    repeated launch the same bits."""
    from repro_torch.kernels import flash_attention as kf
    b, nq, nk, h, kvh, d, causal, window, d_v = shape
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(nq + d)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(dt) for s in
               ((b, nq, h, d), (b, nk, kvh, d), (b, nk, kvh, d)))
    do = torch.randn((b, nq, h, d), generator=gen, device=cuda).to(dt)
    if d_v is not None:
        v[..., d_v:] = 0
        do[..., d_v:] = 0
    kw = dict(causal=causal, window=window)
    out, lse = kf.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    before = kf.bwd_launches
    got = kf.flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
    assert kf.bwd_launches == before + 1
    plan = kf.last_bwd_plan
    assert plan == kf.plan_attention_bwd(dt == torch.bfloat16, b, nq, nk, h,
                                         kvh, d)
    assert plan.route == ("mma" if dtype == "bfloat16" else "simt")
    if dtype == "bfloat16" and kvh == 1 and nq == 300:
        assert plan.splits > 1
    want = kf.flash_attention_bwd_plain(q, k, v, out, do, lse, **kw)
    lim = 1e-5 if dtype == "float32" else 2.0 ** -8
    for g, w in zip(got, want):
        assert g.dtype == dt and g.shape == w.shape
        assert bool(torch.isfinite(g.float()).all())
        assert _rel_norm(g, w) <= lim
    if d_v is not None:
        assert bool((got[2][..., d_v:] == 0).all())
    again = kf.flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


def test_flash_attention_bwd_refuses_wide_heads(cuda):
    """K-B's wrapper raises for a head wider than ``BWD_MAX_D`` (256),
    before any launch, rather than launching at a width it has no form
    for."""
    from repro_torch.kernels import flash_attention as kf
    d = kf.BWD_MAX_D + 32
    q = torch.zeros((1, 8, 2, d), device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 8), device=cuda)
    before = kf.bwd_launches
    with pytest.raises(ValueError, match=f"d <= {kf.BWD_MAX_D}"):
        kf.flash_attention_bwd_cuda(q, q, q, q, q, lse)
    assert kf.bwd_launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("field", ["key_tile", "row_tile", "step_rows"])
def test_flash_attention_bwd_refuses_foreign_tiles(cuda, monkeypatch, dtype,
                                                   field):
    """K-B's C entry refuses a plan whose tiles its route was not built
    for, so the tiles ``last_bwd_plan`` reports are the ones that ran."""
    from repro_torch.kernels import flash_attention as kf
    plan_of = kf.plan_attention_bwd

    def foreign(*args):
        plan = plan_of(*args)
        return plan._replace(**{field: 2 * getattr(plan, field)})

    monkeypatch.setattr(kf, "plan_attention_bwd", foreign)
    q = torch.zeros((1, 64, 2, 64), device=cuda, dtype=dtype)
    lse = torch.zeros((1, 2, 64), device=cuda)
    before = kf.bwd_launches
    with pytest.raises(RuntimeError, match="launch failed"):
        kf.flash_attention_bwd_cuda(q, q, q, q, q, lse)
    assert kf.bwd_launches == before


@pytest.mark.parametrize("shape", [
    (2, 256, 256, 8, 2, 64, True, None),      # prefill, tensor cores
    (4, 1, 300, 8, 2, 128, True, None),       # decode, split-KV + combine
    (2, 128, 128, 4, 1, 576, True, None),     # MLA absorbed, d > 256
    (2, 64, 64, 4, 4, 32, True, 16),          # windowed, CUDA cores
])
def test_flash_attention_lse_changes_no_bit(cuda, shape):
    """K-F's output is the same bits with and without lse; lse against the
    plain version's (both −inf exactly where a row sees no key)."""
    from repro_torch.kernels import flash_attention as kf
    b, nq, nk, h, kvh, d, causal, window = shape
    gen = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(torch.bfloat16)
               for s in ((b, nq, h, d), (b, nk, kvh, d), (b, nk, kvh, d)))
    kw = dict(causal=causal, window=window)
    out = kf.flash_attention_cuda(q, k, v, **kw)
    out2, lse = kf.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, out2)
    _, ref = kf.flash_attention_plain(q, k, v, return_lse=True, **kw)
    assert torch.equal(torch.isinf(lse), torch.isinf(ref))
    fin = torch.isfinite(ref)
    assert float((lse[fin] - ref[fin]).abs().max()) <= 1e-4


def test_flash_attention_cuda_refuses_grad_inputs(cuda):
    """A direct K-F call with an input that requires grad raises (its
    output would carry no gradient); ``ops.flash_attention`` routes the
    same call through ``FlashAttentionFn``: K-F forward, K-B backward,
    the gradient within 1e-5 (‖Δ‖ / ‖ref‖) of the same call's on the CPU
    (the plain forward and backward)."""
    from repro_torch.kernels import flash_attention as kf
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).requires_grad_()
               for s in ((2, 48, 4, 32), (2, 48, 2, 32), (2, 48, 2, 32)))
    with pytest.raises(ValueError, match="requires grad"):
        kf.flash_attention_cuda(q, k, v)
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, causal=True)
    out.square().sum().backward()
    assert ops.launch_counts()["flash_attention"] == 1
    assert ops.launch_counts()["flash_attention_bwd"] == 1
    cpu = [x.detach().cpu().requires_grad_() for x in (q, k, v)]
    ops.flash_attention(*cpu, causal=True).square().sum().backward()
    for a, b_ in zip((q, k, v), cpu):
        assert _rel_norm(a.grad.cpu(), b_.grad) <= 1e-5


def test_train_step_card_equals_cpu(cuda):
    """One ``make_train_step`` step of the reduced llama3.2-3b in float32,
    card against CPU: loss, grad norm and parameters (AdamW) within 1e-5
    relative; K-F twice a layer (remat) and K-B once."""
    from repro_torch import configs
    from repro_torch.models import ModelOptions, init_params
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.tree import leaves_with_path, tree_map
    cfg = configs.get_reduced("llama3.2-3b")
    opts = ModelOptions(dtype=torch.float32, remat=True)
    p_cpu = init_params(cfg, torch.Generator().manual_seed(0), opts,
                        device="cpu")
    p_dev = tree_map(lambda t: t.to(cuda), p_cpu)
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (2, 40)))
             for k in ("tokens", "labels")}
    out = {}
    for where, p in (("cpu", p_cpu), ("card", p_dev)):
        init, step = make_train_step(cfg, TrainConfig(), opts)
        ops.reset_launch_counts()
        out[where] = step(p, init(p), {k: v.to(p["embed"].device)
                                      for k, v in batch.items()})
        out[where + "_counts"] = ops.launch_counts()
    assert out["card_counts"]["flash_attention"] == 2 * cfg.n_layers
    assert out["card_counts"]["flash_attention_bwd"] == cfg.n_layers
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(out["card"][2][key]),
                                   float(out["cpu"][2][key]), rtol=1e-5)
    card = dict(leaves_with_path(out["card"][0]))
    for path, t in leaves_with_path(out["cpu"][0]):
        assert _rel_norm(card[path].cpu(), t) <= 1e-5


# ---- the logit softcap and the read-only decode (A6e)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 256, 256, 8, 2, 64, True, None),      # prefill (tensor cores in bf16)
    (4, 1, 300, 8, 2, 128, True, None),       # decode, split-KV + combine
    (2, 200, 200, 4, 1, 256, True, 64),       # windowed, MQA
    (2, 150, 300, 6, 6, 64, False, None),     # non-causal (cross-attention)
])
def test_flash_attention_softcap_matches_plain(cuda, dtype, shape):
    """K-F and K-B with a cap of 30 against their plain versions (fp32:
    2e-5 abs; bf16: one rounding plus 2⁻¹⁴ of Σ p·|v| forward, ‖Δ‖/‖ref‖
    ≤ 2⁻⁸ backward); a cap of 0 gives the uncapped launch's bits."""
    from repro_torch.kernels import flash_attention as kf
    b, nq, nk, h, kvh, d, causal, window = shape
    g = torch.Generator(device=cuda).manual_seed(25)
    q = (torch.randn((b, nq, h, d), generator=g, device=cuda) * 1.5).to(dtype)
    k = (torch.randn((b, nk, kvh, d), generator=g, device=cuda) * 1.5
         ).to(dtype)
    v = torch.randn((b, nk, kvh, d), generator=g, device=cuda).to(dtype)
    kw = dict(causal=causal, window=window, softcap=30.0)
    out, lse = kf.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    ref = kf.flash_attention_plain(q, k, v, **kw)
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 2e-5
    else:
        terms = kf.flash_attention_plain(q, k, v.abs(), **kw).float()
        lim = (2.0 ** -7 * torch.maximum(out.float().abs(), ref.float().abs())
               + 2.0 ** -14 * terms + 1e-6)
        assert bool((diff <= lim).all())
    assert torch.equal(kf.flash_attention_cuda(q, k, v, causal=causal,
                                               window=window, softcap=0.0),
                       kf.flash_attention_cuda(q, k, v, causal=causal,
                                               window=window))
    if d > kf.BWD_MAX_D:
        return
    do = torch.randn(out.shape, generator=g, device=cuda).to(dtype)
    got = kf.flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
    want = kf.flash_attention_bwd_plain(q, k, v, out, do, lse, **kw)
    for a, w in zip(got, want):
        rel = float((a.float() - w.float()).norm() / w.float().norm())
        assert rel <= (1e-5 if dtype == torch.float32 else 2.0 ** -8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,kvh,t_new", [(128, 2, 1), (576, 1, 1), (64, 4, 3)])
def test_flash_attention_appended_keys_match_plain(cuda, dtype, d, kvh,
                                                   t_new):
    """K-F over a cache's live keys read in place (a strided slice) with
    fresh keys as its second source: the concatenation's function (the
    plain version), and the same bits as the concatenated call."""
    from repro_torch.kernels import flash_attention as kf
    g = torch.Generator(device=cuda).manual_seed(26)
    b, h, nk = 3, 2 * kvh, 700
    q = torch.randn((b, 1, h, d), generator=g, device=cuda).to(dtype)
    cache = torch.randn((b, nk + 64, kvh, d), generator=g, device=cuda
                        ).to(dtype)
    vcache = torch.randn((b, nk + 64, kvh, d), generator=g, device=cuda
                         ).to(dtype)
    kn = torch.randn((b, t_new, kvh, d), generator=g, device=cuda).to(dtype)
    vn = torch.randn((b, t_new, kvh, d), generator=g, device=cuda).to(dtype)
    k, v = cache[:, :nk], vcache[:, :nk]
    before = (cache.clone(), vcache.clone())
    out = kf.flash_attention_cuda(q, k, v, causal=False, k_new=kn, v_new=vn)
    assert kf.last_plan.route == "simt"
    assert torch.equal(cache, before[0]) and torch.equal(vcache, before[1])
    cat = kf.flash_attention_cuda(q, torch.cat([k, kn], 1),
                                  torch.cat([v, vn], 1), causal=False)
    assert torch.equal(out, cat)
    ref = kf.flash_attention_plain(q, k, v, causal=False, k_new=kn, v_new=vn)
    tol = 2e-5 if dtype == torch.float32 else 2.0 ** -7
    assert float((out.float() - ref.float()).abs().max()) <= tol * max(
        1.0, float(ref.float().abs().max()))
