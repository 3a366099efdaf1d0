"""The quantized tier, port vs JAX package: the int8 representation, the
in-step query quantization, the certified lower bound, the coarse
scan's plain versions and the two-tier engine (resident and
host-gather), on the CPU from the same numpy inputs and a JAX-built
quantized index carried across. Plus the port's own invariants: the
quant tier equals the fp32 megastep and the host-planned path bitwise,
batched equals one-shot for any split, the ε lemma holds against the
float64 reconstruction ŝ = codes·scale, and certification failures go
through the oracle and are counted.

Tolerances: codes, scales, ε of ``quantize_rows`` bit-equal (numpy in
both packages); query ε within 4 ulp; the certified lb within twice the
rounding allowance ε_num the bound itself budgets — XLA contracts
(q2 + s2) − 2·qs·ss·c into an FMA, which moves d² by up to one ulp of
‖q̂‖² + ‖ŝ‖² (ROADMAP Queue C1), not by ulps of lb; shortlist positions
equal except where the two lbs tie within that allowance; final
distances within 4 ulp of the JAX package and bitwise the port's fp32
paths."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import JoinConfig as JConfig  # noqa: E402
from repro.core import brute_force_knn as j_brute  # noqa: E402
from repro.core import build_index as j_build_index  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.quant_topk import coarse_lb_tile as j_lb_tile  # noqa: E402
from repro.quant import QuantMegastepEngine as JQuant  # noqa: E402
from repro.quant import quantize_queries_jnp  # noqa: E402
from repro.quant import quantize_queries_np as j_qq  # noqa: E402
from repro.quant import quantize_rows as j_qr  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quant_topk as kq  # noqa: E402
from repro_torch.quant import autotune  # noqa: E402
from repro_torch.quant import quantize_queries_np, quantize_rows  # noqa: E402
from repro_torch.quant.engine import quantize_queries  # noqa: E402

from torch_parity import (ULP_BOUND, assert_same_join, data,  # noqa: E402
                          index_arrays, ulps)

CFG = dict(k=10, n_pivots=24, tile_r=32, tile_s=64, quantize="int8",
           quant_slack=22, reducer="gather")


def _rows(n, dim, seed, scale=3.0, offset=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, dim)) * scale + offset).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pair(kind="forest", seed=0, **kw):
    s, r = data(kind, n_s=2000, n_r=240, seed=seed)
    cfg = dict(CFG, **kw)
    jidx = j_build_index(s, JConfig(**cfg))
    tidx = rt.sindex_from_arrays(
        index_arrays(jidx, quant_bn=cfg["tile_s"]), rt.JoinConfig(**cfg),
        device="cpu")
    return s, r, jidx, tidx, cfg


def _allowance(qi, qscale, si, sscale):
    """Twice ε_num per pair, in float64: the float32 rounding allowance
    of the rescale + √ that the certified bound budgets."""
    q2 = (qscale.astype(np.float64) ** 2
          * (qi.astype(np.float64) ** 2).sum(1))[:, None]
    s2 = (sscale.astype(np.float64) ** 2
          * (si.astype(np.float64) ** 2).sum(1))[None, :]
    c = qi.astype(np.float64) @ si.astype(np.float64).T
    dc = np.sqrt(np.maximum(q2 + s2 - 2 * (qscale[:, None] * sscale[None, :])
                            * c, 0.0))
    delta = kq.NUM_DELTA_REL * (q2 + s2)
    return 2 * delta / np.maximum(dc, np.sqrt(delta)) + 1e-6


# ---------------------------------------------------------------------------
# the representation


@pytest.mark.parametrize("n,dim,bn,scale,offset", [
    (1000, 12, 128, 2.5, 1.0), (577, 10, 64, 300.0, 500.0),
    (64, 3, 64, 1e-3, 0.0), (5, 7, 16, 0.0, 0.0)])
def test_quantize_rows_bit_equal(n, dim, bn, scale, offset):
    rows = _rows(n, dim, n, scale, offset)
    got, want = quantize_rows(rows, bn), j_qr(rows, bn)
    np.testing.assert_array_equal(got.q, want.q)
    np.testing.assert_array_equal(got.scales.view(np.int32),
                                  want.scales.view(np.int32))
    np.testing.assert_array_equal(got.eps.view(np.int16),
                                  want.eps.view(np.int16))
    assert (got.bn, got.n_rows, got.nbytes()) == (want.bn, want.n_rows,
                                                   want.nbytes())
    qi, qs, qe = quantize_queries_np(rows)
    for a, b in zip((qi, qs, qe), j_qq(rows)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("offset", [0.0, 700.0])
def test_in_step_query_quantization_matches_jax(offset):
    """Codes and scales exactly; ε within 4 ulp (the float32 norm sums in
    another order) and an upper bound on the float64 error."""
    q = _rows(300, 10, 1, 200.0, offset)
    codes, scale, eps = quantize_queries(_t(q))
    jc, js, je = (np.asarray(x) for x in quantize_queries_jnp(q))
    np.testing.assert_array_equal(codes.numpy(), jc)
    np.testing.assert_array_equal(scale.numpy(), js)
    assert ulps(eps.numpy(), je).max() <= ULP_BOUND
    recon = codes.numpy().astype(np.float64) * scale.numpy()[:, None]
    err = np.sqrt(((q.astype(np.float64) - recon) ** 2).sum(1))
    assert (eps.numpy() >= err).all()


@pytest.mark.parametrize("offset", [0.0, 500.0])
def test_coarse_lb_tile_matches_jax(offset):
    s = _rows(128, 10, 2, 100.0, offset)
    q = _rows(40, 10, 3, 100.0, offset)
    qr = quantize_rows(s, 64)
    qi, qs, qe = quantize_queries_np(q)
    for t in range(2):
        si = qr.q[t * 64:(t + 1) * 64]
        seps = qr.eps[t * 64:(t + 1) * 64].astype(np.float32)
        got = kq.coarse_lb_tile(_t(qi), _t(qs), _t(qe), _t(si),
                                float(qr.scales[t]), _t(seps)).numpy()
        want = np.asarray(j_lb_tile(qi, qs, qe, si, qr.scales[t], seps))
        tol = _allowance(qi, qs, si, np.full(64, qr.scales[t]))
        assert (np.abs(got.astype(np.float64) - want) <= tol).all()


def _soundness_case(dim, n_s, n_q, scale, offset, seed):
    """The ε lemma against the float64 reconstruction ŝ = codes·scale,
    and the port's float32 lower bound below the true distance."""
    s = _rows(n_s, dim, seed, scale, offset)
    q = _rows(n_q, dim, seed + 1, scale, offset)
    bn = 32
    qr = quantize_rows(s, bn)
    qi, qs, qe = quantize_queries_np(q)
    s64 = s.astype(np.float64)
    shat = qr.dequantized(np.float64)[:n_s]
    qhat = qi.astype(np.float64) * qs.astype(np.float64)[:, None]
    d_true = np.sqrt(((q.astype(np.float64)[:, None] - s64[None]) ** 2)
                     .sum(-1))
    d_shat = np.sqrt(((q.astype(np.float64)[:, None] - shat[None]) ** 2)
                     .sum(-1))
    d_qhat = np.sqrt(((qhat[:, None] - shat[None]) ** 2).sum(-1))
    eps_s = qr.eps.astype(np.float64)[:n_s]
    assert (np.abs(d_shat - d_true) <= eps_s[None, :] + 1e-9).all()
    both = eps_s[None, :] + qe.astype(np.float64)[:, None]
    assert (np.abs(d_qhat - d_true) <= both + 1e-9).all()
    lb = kq.coarse_lb_tile(
        _t(qi), _t(qs), _t(qe), _t(qr.q),
        _t(np.repeat(qr.scales, bn)), _t(qr.eps)).numpy()[:, :n_s]
    assert (lb <= d_true + 1e-6).all()


@pytest.mark.parametrize("dim,n_s,n_q,scale,offset,seed", [
    (2, 64, 16, 1.0, 0.0, 0), (8, 200, 40, 3.0, 0.0, 1),
    (12, 150, 20, 0.2, 5.0, 2), (16, 96, 8, 25.0, -40.0, 3),
    (5, 33, 7, 1e-3, 0.0, 4),
    # the falsifying example of the JAX package's f32-ŝ lemma test
    (2, 48, 1, 3.482421875, 7.0, 65536)])
def test_epsilon_lemma_against_float64_reconstruction(dim, n_s, n_q, scale,
                                                      offset, seed):
    _soundness_case(dim, n_s, n_q, scale, offset, seed)


def test_epsilon_lemma_hypothesis():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @given(st.integers(2, 16), st.integers(16, 200), st.integers(1, 40),
           st.floats(0.1, 30.0), st.floats(-50.0, 50.0),
           st.integers(0, 2 ** 16))
    @settings(max_examples=40, deadline=None, database=None)
    def run(dim, n_s, n_q, scale, offset, seed):
        _soundness_case(dim, n_s, n_q, scale, offset, seed)

    run()


# ---------------------------------------------------------------------------
# the coarse scan's plain versions


def _coarse_inputs(seed, n_r=96, n_s=640, dim=10, bm=32, bn=64, dead=0.1,
                   offset=0.0):
    rng = np.random.default_rng(seed)
    s = _rows(n_s, dim, seed, 50.0, offset)
    q = _rows(n_r, dim, seed + 1, 50.0, offset)
    qr = quantize_rows(s, bn)
    qi, qs, qe = quantize_queries_np(q)
    alive = ((np.arange(qr.q.shape[0]) < n_s)
             & (rng.random(qr.q.shape[0]) >= dead)).astype(np.float32)
    d = np.sqrt(((q[:, None].astype(np.float64) - s[None]) ** 2).sum(-1))
    theta = np.quantile(d, 0.3, axis=1).astype(np.float32)
    nr_t, ns_t = -(-n_r // bm), qr.n_tiles
    counts = rng.integers(1, ns_t + 1, nr_t).astype(np.int32)
    sched = np.zeros((nr_t, ns_t), np.int32)
    for t in range(nr_t):
        pick = np.sort(rng.choice(ns_t, counts[t], replace=False))
        sched[t, :counts[t]], sched[t, counts[t]:] = pick, pick[-1]
    return (qi, qs, qe, theta, qr.q, qr.scales, qr.eps, alive), sched, counts


def _assert_shortlists_agree(lb, pos, jlb, jpos, allowance):
    fin = np.isfinite(jlb)
    assert (np.isfinite(lb) == fin).all()
    assert (np.abs(lb[fin].astype(np.float64) - jlb[fin])
            <= allowance).all()
    mism = pos != jpos
    assert (np.abs(lb[mism].astype(np.float64) - jlb[mism])
            <= allowance).all()


@pytest.mark.parametrize("mp,offset", [(16, 0.0), (64, 300.0)])
def test_sched_plain_matches_jax_scan_twin(mp, offset):
    """The schedule walk against the JAX package's ``ref_sched`` (and
    the Pallas kernel in interpret mode on the smaller case)."""
    args, sched, counts = _coarse_inputs(mp, offset=offset)
    lb, pos = kq.quant_coarse_sched_plain(*(_t(a) for a in args), mp,
                                          _t(sched), _t(counts), bm=32, bn=64)
    impls = ("ref_sched", "pallas_interpret") if mp == 16 else ("ref_sched",)
    q_pad = -(-args[0].shape[0] // 32) * 32
    allowance = float(_allowance(args[0], args[1], args[4],
                                 np.repeat(args[5], 64)).max())
    for impl in impls:
        jlb, jpos = jops.quant_coarse_topk(
            *args, mp, schedule=sched, counts=counts, bm=32, bn=64,
            impl=impl)
        _assert_shortlists_agree(lb.numpy(), pos.numpy(),
                                 np.asarray(jlb)[:q_pad],
                                 np.asarray(jpos)[:q_pad], allowance)


def test_dense_plain_matches_jax_ref_and_full_schedule():
    """The dense oracle against the JAX package's; the schedule walk over
    a full schedule equals it bit for bit."""
    args, _, _ = _coarse_inputs(5, dead=0.0)
    targs = [_t(a) for a in args]
    lb, pos = kq.quant_coarse_topk_plain(*targs, 32, bn=64)
    jlb, jpos = jops.quant_coarse_topk(*args, 32, bn=64, impl="ref")
    allowance = float(_allowance(args[0], args[1], args[4],
                                 np.repeat(args[5], 64)).max())
    _assert_shortlists_agree(lb.numpy(), pos.numpy(), np.asarray(jlb),
                             np.asarray(jpos), allowance)
    n_t = args[4].shape[0] // 64
    full = torch.arange(n_t, dtype=torch.int32).repeat(3, 1)
    slb, spos = kq.quant_coarse_sched_plain(
        *targs, 32, full, torch.full((3,), n_t, dtype=torch.int32), bm=32,
        bn=64)
    assert torch.equal(slb.view(torch.int32), lb.view(torch.int32))
    assert torch.equal(spos, pos)


def test_sched_plain_walks_only_live_slots_and_breaks_ties_low():
    args, sched, counts = _coarse_inputs(9, dead=0.0)
    targs = [_t(a) for a in args]
    lb, pos = kq.quant_coarse_sched_plain(*targs, 32, _t(sched),
                                          _t(counts), bm=32, bn=64)
    p = pos.numpy()
    for i in range(p.shape[0]):
        live_tiles = set(sched[i // 32, :counts[i // 32]].tolist())
        assert {int(x) // 64 for x in p[i] if x >= 0} <= live_tiles
    # a duplicated S tile walked high tile first: every lb appears
    # twice, and the run is ordered by (lb, position) — the lower
    # position first — whatever the schedule's order
    dup = list(args)
    dup[4] = np.concatenate([args[4][:64], args[4][:64]])
    dup[5] = np.concatenate([args[5][:1], args[5][:1]])
    dup[6] = np.concatenate([args[6][:64], args[6][:64]])
    dup[7] = np.ones(128, np.float32)
    lb2, pos2 = kq.quant_coarse_sched_plain(
        *(_t(a) for a in dup), 128, torch.tensor([[1, 0]] * 3,
                                                 dtype=torch.int32),
        torch.full((3,), 2, dtype=torch.int32), bm=32, bn=64)
    for lbs, ps in zip(lb2.numpy(), pos2.numpy()):
        row = [(float(a), int(b)) for a, b in zip(lbs, ps) if b >= 0]
        assert row == sorted(row) and len(row) % 2 == 0
        assert all(row[j][1] + 64 == row[j + 1][1]
                   for j in range(0, len(row), 2))


# ---------------------------------------------------------------------------
# the engine


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("kind", ["forest", "gaussian"])
def test_quant_engine_matches_jax(kind, resident):
    """Shortlists and results against the JAX engine (``ref_sched``) on
    the same quantized index; both against the JAX brute force."""
    s, r, jidx, tidx, cfg = _pair(kind)
    je = JQuant(jidx, JConfig(**cfg), impl="ref_sched", resident=resident)
    te = rt.QuantMegastepEngine(tidx, rt.JoinConfig(**cfg),
                                resident=resident, device="cpu")
    assert (te.mode, te.mp, te.resident) == (je.mode, je.mp, je.resident)
    jlb, jpos, jids = je.coarse_shortlist(r)
    lb, pos, ids = te.coarse_shortlist(r)
    qi, qs, _ = quantize_queries_np(r)
    qr = jidx.ensure_quant(cfg["tile_s"])
    allowance = float(_allowance(qi, qs, qr.q,
                                 np.repeat(qr.scales, cfg["tile_s"])).max())
    _assert_shortlists_agree(lb, pos, jlb, jpos, allowance)
    np.testing.assert_array_equal(ids[pos == jpos], jids[pos == jpos])
    jst, tst = rt.JoinStats(), rt.JoinStats()
    jd, ji = je.join_batch(r, stats=jst)
    d, i = te.join_batch(r, stats=tst)
    assert_same_join(d, i, jd, ji)
    bd, bi = j_brute(r, s, cfg["k"])
    assert_same_join(d, i, bd, bi)
    assert (tst.quant_mode, tst.quant_mp) == (jst.quant_mode, jst.quant_mp)
    assert tst.n_resident_rerank == jst.n_resident_rerank
    assert tst.n_host_rerank == jst.n_host_rerank


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("kind", ["forest", "gaussian"])
def test_quant_equals_fp32_megastep_and_host_path_bitwise(kind, resident):
    s, r = data(kind, n_s=2000, n_r=240, seed=4)
    cfg = rt.JoinConfig(**CFG)
    idx = rt.build_index(s, cfg, device="cpu")
    assert idx.config.quantize == "int8" and 64 in idx._quant
    quant = rt.QuantMegastepEngine(idx, cfg, resident=resident,
                                   device="cpu").join_batch(r)
    mega = rt.knn_join(r, index=idx, megastep=True, quantized=False,
                       device="cpu")
    host = rt.knn_join(r, index=idx, quantized=False, device="cpu")
    for ref in (mega, host):
        np.testing.assert_array_equal(quant[0], ref.distances)
        mism = quant[1] != ref.indices
        np.testing.assert_array_equal(quant[0][mism], ref.distances[mism])


@pytest.mark.parametrize("splits", [(240,), (37, 64, 139), (128, 112)])
def test_quant_batched_equals_one_shot_any_split(splits):
    s, r = data("forest", n_s=2000, n_r=240, seed=5)
    idx = rt.build_index(s, rt.JoinConfig(**CFG), device="cpu")
    one = rt.knn_join(r, index=idx, quantized=True, device="cpu")
    assert one.stats.quant_mode == "int8"
    parts = np.split(r, np.cumsum(splits)[:-1])
    many = rt.knn_join_batched(iter(parts), index=idx, quantized=True,
                               device="cpu")
    np.testing.assert_array_equal(many.distances, one.distances)
    np.testing.assert_array_equal(many.indices, one.indices)
    assert many.stats.n_r == one.stats.n_r == r.shape[0]


def test_certification_failures_fall_back_and_are_counted():
    """A bare shortlist (slack 0 → mp = 16 at k = 10) cannot certify
    most Forest-like queries: they re-run through the fp32 host path,
    are counted, and the result stays exact."""
    s, r = data("forest", n_s=2000, n_r=240, seed=6)
    cfg = rt.JoinConfig(**dict(CFG, quant_slack=0))
    idx = rt.build_index(s, cfg, device="cpu")
    eng = rt.QuantMegastepEngine(idx, cfg, device="cpu")
    assert eng.mp == 16
    stats = rt.JoinStats()
    with rt.obs.metrics.scoped() as reg, rt.obs.capture() as tr:
        d, i = eng.join_batch(r, stats=stats)
    assert 0 < stats.n_quant_fallback <= r.shape[0]
    assert reg.snapshot()["quant_fallback_total"] == stats.n_quant_fallback
    assert "quant.fallback" in {sp.name for sp in tr.spans()}
    bd, bi = rt.brute_force_knn(r, s, cfg.k, device="cpu")
    np.testing.assert_array_equal(d, bd)
    # the shortlist the certification read: ascending lb, ids on the
    # filled slots only
    lb, pos, ids = eng.coarse_shortlist(r[:20])
    assert (np.diff(lb, axis=1)[np.isfinite(lb[:, 1:])] >= 0).all()
    assert ((ids >= 0) == (pos >= 0)).all()


def test_resident_step_makes_no_host_sync(monkeypatch):
    s, r = data("gaussian", n_s=1500, seed=7)
    idx = rt.build_index(s, rt.JoinConfig(**CFG), device="cpu")
    eng = rt.QuantMegastepEngine(idx, resident=True, device="cpu")
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
    assert all(torch.equal(a, b) for a, b in zip(out, warm))
    host = rt.QuantMegastepEngine(idx, resident=False, device="cpu")
    with pytest.raises(NotImplementedError, match="host-gather"):
        host.join_batch_device(q, n)


def test_quantized_routes_and_memory():
    s, r = data("gaussian", n_s=1500, n_r=100, seed=8)
    cfg = rt.JoinConfig(**dict(CFG, quantize="none"))
    idx = rt.build_index(s, cfg, quantize="int8", device="cpu")
    assert idx.config.quantize == "int8"
    fp32 = idx.nbytes_resident(quantized=False)
    assert fp32 == s.nbytes
    assert idx.nbytes_resident() == idx.ensure_quant().nbytes() < fp32 / 3
    a = rt.knn_join(r, index=idx, device="cpu")          # config → int8
    b = rt.knn_join_batched(r, index=idx, batch_size=40, device="cpu")
    eng = rt.StreamJoinEngine(idx, device="cpu")
    assert isinstance(eng.megastep_engine, rt.QuantMegastepEngine)
    c = eng.finalize(eng.dispatch(r))
    for d in (b.distances, c[0]):
        np.testing.assert_array_equal(d, a.distances)
    assert a.stats.quant_mode == b.stats.quant_mode == "int8"
    with pytest.raises(ValueError, match="l2"):
        rt.QuantMegastepEngine(idx, dataclasses.replace(cfg, metric="l1"),
                               device="cpu")


def test_tuning_table_routes_and_round_trips(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="power of two"):
        autotune.TunedConfig(mode="int8", mp=100)
    with pytest.raises(ValueError, match="mode"):
        autotune.TunedConfig(mode="int4")
    table = autotune.TuningTable()
    table.put(8, 1500, 10, "cpu", autotune.TunedConfig(
        mode="fp32", int8_batch_s=2.0, fp32_batch_s=1.0))
    assert autotune.table_key(8, 1500, 10, "cpu") == "cpu|d8|n2048|k10"
    path = tmp_path / "tune.json"
    table.save(str(path))
    assert autotune.TuningTable.load(str(path)).entries == table.entries
    assert autotune.lookup(8, 1500, 10, "cpu") is None   # ships empty
    monkeypatch.setenv("REPRO_TORCH_QUANT_TUNE_TABLE", str(path))
    autotune.reset_default_table()
    try:
        s, r = data("gaussian", n_s=1500, n_r=60, seed=9)
        cfg = rt.JoinConfig(**dict(CFG, quant_slack=-1))
        idx = rt.build_index(s, cfg, device="cpu")
        eng = rt.QuantMegastepEngine(idx, cfg, device="cpu")
        assert (eng.mode, eng.autotuned, eng.resident) == ("fp32", True,
                                                           False)
        stats = rt.JoinStats()
        d, _ = eng.join_batch(r, stats=stats)
        assert (stats.quant_mode, stats.quant_autotuned) == ("fp32", True)
        with pytest.raises(RuntimeError, match="fp32"):
            eng.coarse_shortlist(r)
        pinned = rt.QuantMegastepEngine(idx, cfg, slack=22, device="cpu")
        assert pinned.mode == "int8" and pinned.mp == 32
        np.testing.assert_array_equal(pinned.join_batch(r)[0], d)
    finally:
        monkeypatch.delenv("REPRO_TORCH_QUANT_TUNE_TABLE")
        autotune.reset_default_table()


def test_sweep_config_smoke():
    s, _ = data("gaussian", n_s=1500, seed=10)
    idx = rt.build_index(s, rt.JoinConfig(**dict(CFG, quant_slack=-1)),
                         device="cpu")
    tuned = autotune.sweep_config(idx, batch=64, iters=1, mps=(32,))
    assert tuned.mode in ("int8", "fp32")
    assert np.isfinite(tuned.fp32_batch_s) and np.isfinite(
        tuned.int8_batch_s)
    eng = rt.QuantMegastepEngine(idx, tune=tuned, device="cpu")
    assert eng.autotuned and eng.mode == tuned.mode
    ops.reset_launch_counts()
    eng.join_batch(s[:30])
    assert set(ops.launch_counts().values()) == {0}
