"""How the CUDA kernels K-D and K-Q cut their work and screen their pairs,
held on the CPU.

K-D (``csrc/dense_topk.cu``) runs in one of two forms that
``kernels.distance_topk.plan_dense`` picks from the static shapes, and cuts
S into contiguous ranges of S tiles whose partial runs a merge pass folds;
K-Q (``csrc/quant_coarse.cu``) cuts each R tile's schedule row into ranges
(``kernels.quant_topk.plan_quant``) and drops, before the √ chain, every
pair whose coarse d2 exceeds a limit T (``quant_topk.screen_limit_plain``).
The kernels run only on a card; here their planners, their split models
(``tests/torch_parity.py``) and the screen are held against the unsplit
plain versions, against exact rational arithmetic and against the JAX
package, on numpy-seeded inputs.

Tolerances: the cuts are exact (a total order on unique positions), so bit
for bit. The screen must never drop a pair whose exact lb is ≤ the cut:
no tolerance. The JAX parity at the new form boundaries uses the
tolerances of ``tests/test_torch_dense.py`` and ``tests/test_torch_quant.py``
(d² within 2⁻¹⁸ of the largest ‖r‖²+‖s‖²; lb within twice ε_num)."""
import inspect
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.distance_topk import distance_topk_pallas  # noqa: E402
from repro_torch.kernels import distance_topk as kd  # noqa: E402
from repro_torch.kernels import quant_topk as kq  # noqa: E402
from repro_torch.quant import quantize_queries_np, quantize_rows  # noqa: E402

from torch_parity import (assert_d_close, dense_split_plain,  # noqa: E402
                          quant_split_plain)


def _covered(n, splits, per):
    covered = np.zeros(n, np.int64)
    for i in range(splits):
        covered[i * per:(i + 1) * per] += 1
    return covered


# ---- (a) the planners cover every S tile / visit slot exactly once


@pytest.mark.parametrize("n_r,n_s,d,k,bm,bn", [
    (4096, 522911, 10, 10, 128, 512),    # retrieval shape (a)
    (256, 262144, 1024, 8, 128, 512),    # kNN-LM width (c)
    (4096, 522911, 10, 128, 128, 512),   # phase 13's k = 128
    (301, 4999, 32, 64, 128, 512),       # the narrow form's widest
    (301, 4999, 33, 1, 128, 512),        # the tile form's narrowest
    (1, 1, 1, 1, 1, 1),
    (7, 100000, 3, 5, 300, 7),           # bm past one block, tiny tiles
])
def test_dense_planner_covers_every_tile_once(n_r, n_s, d, k, bm, bn):
    assert all(p.annotation in ("int", "Optional[int]", "Optional[str]")
               for p in inspect.signature(kd.plan_dense).parameters.values())
    ns_tiles = -(-n_s // bn)
    for splits in (None, 1, 3, 10 ** 6):
        plan = kd.plan_dense(n_r, n_s, d, k, bm, bn, splits=splits)
        assert plan.form == ("narrow" if d <= 32 and k <= 64 else "tile")
        assert plan.qblocks == -(-bm // 128)
        assert 1 <= plan.splits <= 65535 and plan.per >= 1
        assert (_covered(ns_tiles, plan.splits, plan.per) == 1).all()
        assert (plan.splits - 1) * plan.per < ns_tiles   # no empty split
    with pytest.raises(ValueError):
        kd.plan_dense(n_r, n_s, 33, k, bm, bn, form="narrow")
    with pytest.raises(ValueError):
        kd.plan_dense(n_r, n_s, d, 65, bm, bn, form="narrow")
    assert kd.plan_dense(n_r, n_s, d, k, bm, bn, form="tile").form == "tile"


@pytest.mark.parametrize("n_r,d,mp,bm,bn,max_visits", [
    (4096, 10, 128, 128, 512, 1135),     # a Forest bucket
    (4096, 256, 128, 128, 512, 128),     # d = 256
    (4096, 10, 1024, 128, 512, 1135),    # wide runs
    (4096, 10, 512, 128, 512, 1135),     # the widest shared-memory run
    (300, 33, 64, 32, 128, 16),          # a small R tile
    (100, 300, 16, 128, 64, 1),          # one visit, past d = 256
    (1, 3, 1, 1, 40, 70000),             # more visits than a grid axis
])
def test_quant_planner_covers_every_slot_once(n_r, d, mp, bm, bn,
                                              max_visits):
    assert all(p.annotation in ("int", "Optional[int]")
               for p in inspect.signature(kq.plan_quant).parameters.values())
    for splits in (None, 1, 3, 10 ** 6):
        plan = kq.plan_quant(n_r, d, mp, bm, bn, max_visits, splits=splits)
        assert 1 <= plan.splits <= 65535 and plan.per >= 1
        assert (_covered(max_visits, plan.splits, plan.per) == 1).all()
        assert (plan.splits - 1) * plan.per < max_visits
        assert plan.wide == (mp > 512)
        assert plan.qb == 16 * plan.qpw and plan.qpw in (1, 2, 4)
        if not plan.wide:
            assert plan.qb * mp * 8 <= 64 * 1024
        assert 1 <= plan.chunk <= bn
        if bn % 16 == 0:
            assert plan.chunk % 16 == 0
        assert kq.quant_smem_bytes(plan.qb, mp, d, plan.chunk,
                                   plan.wide) <= 227 * 1024
    # 64 queries a block where their runs fit, fewer past that
    assert kq.plan_quant(4096, 10, 128, 128, 512, 1135).qb == 64
    assert kq.plan_quant(4096, 10, 512, 128, 512, 1135).qb == 16


# ---- (b) the plain versions cut at the splits and merged are the unsplit
# plain versions, bit for bit


def _dense_case(seed, n_r=150, n_s=1500, d=6, bm=32, bn=64):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(n_s, d)).astype(np.float32)
    s[n_s // 2:] = s[rng.integers(0, n_s // 2, n_s - n_s // 2)]  # ties
    r = rng.normal(size=(n_r, d)).astype(np.float32)
    r[:10] = s[:10]
    mask = (rng.random((-(-n_r // bm), -(-n_s // bn))) < 0.6).astype(np.int8)
    return torch.from_numpy(r), torch.from_numpy(s), torch.from_numpy(mask)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k,d", [(5, 6), (10, 33), (70, 4)])
@pytest.mark.parametrize("splits", [1, 2, 7, 24])
def test_dense_split_merge_is_bitwise_unsplit(k, d, splits, masked):
    r, s, mask = _dense_case(k + d, d=d)
    mask = mask if masked else None
    plan = kd.plan_dense(r.shape[0], s.shape[0], d, k, 32, 64,
                         splits=splits)
    kw = dict(visit_mask=mask, bm=32, bn=64)
    want_d, want_p = kd.distance_topk_plain(r, s, k, **kw)
    got_d, got_p = dense_split_plain(r, s, k, plan, **kw)
    assert torch.equal(got_d.view(torch.int32), want_d.view(torch.int32))
    assert torch.equal(got_p, want_p)
    fin = torch.isfinite(want_d)     # the duplicates do tie
    assert bool(((want_d[:, 1:] == want_d[:, :-1]) & fin[:, 1:]).any())


def _coarse_case(seed, n_r=96, n_s=640, dim=10, bm=32, bn=64, dead=0.1,
                 scale=50.0):
    rng = np.random.default_rng(seed)
    s = (rng.normal(size=(n_s, dim)) * scale).astype(np.float32)
    s[n_s // 2:n_s // 2 + 40] = s[:40]                           # lb ties
    q = (rng.normal(size=(n_r, dim)) * scale).astype(np.float32)
    qr = quantize_rows(s, bn)
    qi, qs, qe = quantize_queries_np(q)
    alive = ((np.arange(qr.q.shape[0]) < n_s)
             & (rng.random(qr.q.shape[0]) >= dead)).astype(np.float32)
    args = [torch.from_numpy(np.array(x)) for x in (
        qi, qs, qe, np.zeros(n_r, np.float32), qr.q, qr.scales, qr.eps,
        alive)]
    lb = kq.coarse_lb_tile(args[0], args[1], args[2], args[4],
                           torch.repeat_interleave(args[5], bn), args[6])
    # θ at exact lb values: many pairs sit at the cut
    args[3] = lb[torch.arange(n_r), torch.as_tensor(
        rng.integers(0, lb.shape[1], n_r))].contiguous()
    nr_t, ns_t = -(-n_r // bm), qr.n_tiles
    counts = rng.integers(1, ns_t + 1, nr_t).astype(np.int32)
    sched = np.zeros((nr_t, ns_t), np.int32)
    for t in range(nr_t):
        pick = np.sort(rng.choice(ns_t, counts[t], replace=False))
        sched[t, :counts[t]], sched[t, counts[t]:] = pick, pick[-1]
    return args, torch.from_numpy(sched), torch.from_numpy(counts)


@pytest.mark.parametrize("mp", [4, 16, 64])
@pytest.mark.parametrize("splits", [1, 2, 5, 10])
def test_quant_split_merge_is_bitwise_unsplit(mp, splits):
    args, sched, counts = _coarse_case(mp + splits)
    plan = kq.plan_quant(96, 10, mp, 32, 64, sched.shape[1], splits=splits)
    want_lb, want_p = kq.quant_coarse_sched_plain(*args, mp, sched, counts,
                                                  bm=32, bn=64)
    got_lb, got_p = quant_split_plain(args, mp, sched, counts, plan, bm=32,
                                      bn=64)
    assert torch.equal(got_lb.view(torch.int32), want_lb.view(torch.int32))
    assert torch.equal(got_p, want_p)
    assert bool(torch.isfinite(want_lb).any())


# ---- (c) the screen is sound


def _exact_ru(x: Fraction) -> np.float32:
    """The float32 at or above the rational x (finite)."""
    f = np.float32(float(x))
    if Fraction(float(f)) < x:
        f = np.nextafter(f, np.float32(np.inf))
    while True:
        lo = np.nextafter(f, np.float32(-np.inf))
        if Fraction(float(lo)) >= x:
            f = lo
        else:
            return f


def test_round_up_helpers_are_exact():
    """The float64 emulation of CUDA's __fadd_ru / __fmul_ru / __fsqrt_ru
    against exact rational arithmetic."""
    rng = np.random.default_rng(17)
    a = (rng.normal(size=400) * 10.0 ** rng.integers(-18, 18, 400)) \
        .astype(np.float32)
    b = (rng.normal(size=400) * 10.0 ** rng.integers(-18, 18, 400)) \
        .astype(np.float32)
    b[:50] = -a[:50] * np.float32(1.0000001)     # cancellation
    b[50:100] = np.float32(1e-38)                 # far-apart magnitudes
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got_add = kq._add_ru(ta, tb).numpy()
    got_mul = kq._mul_ru(ta, tb).numpy()
    got_sqrt = kq._sqrt_ru(ta.abs()).numpy()
    for i in range(a.shape[0]):
        fa, fb = Fraction(float(a[i])), Fraction(float(b[i]))
        assert got_add[i] == _exact_ru(fa + fb)
        assert got_mul[i] == _exact_ru(fa * fb)
        s = got_sqrt[i]
        lo = np.nextafter(s, np.float32(-np.inf))
        assert Fraction(float(s)) ** 2 >= abs(fa)
        assert s == 0 or Fraction(float(lo)) ** 2 < abs(fa)


def _chain(qi, qsc, qe, si, ssc, seps):
    """The kernel's d2 and lb per (query, row) pair, each op rounded as it
    rounds them; plus q2 and s2."""
    c = torch.matmul(qi.to(torch.float64), si.to(torch.float64).T) \
        .to(torch.float32)
    a = qi.to(torch.int32).square().sum(1).to(torch.float32)
    b = si.to(torch.int32).square().sum(1).to(torch.float32)
    q2 = (qsc * qsc) * a
    s2 = (ssc * ssc) * b
    qs2 = q2[:, None] + s2[None, :]
    d2 = qs2 - (2.0 * (qsc[:, None] * ssc[None, :])) * c
    lb = kq._lb_chain(c, a, b, qsc, qe, ssc, seps)
    return d2, lb, q2, s2


@pytest.mark.parametrize("scale", [1e-18, 1e-3, 1.0, 50.0, 1e6, 1e12])
@pytest.mark.parametrize("dim", [3, 10, 33])
def test_screen_never_drops_a_pair_at_or_under_the_cut(scale, dim):
    """Random and adversarial tiles: cuts exactly at a pair's lb and one
    ulp either side of it, queries equal to rows (d_coarse under √δ),
    θ = ±inf, dead rows (out of the tile's maxima). A pair the screen
    drops (d2 > T) always has lb > cut or a NaN lb."""
    rng = np.random.default_rng(int(100 * dim + np.log10(scale) + 20))
    n_q, bn = 64, 256
    s = (rng.normal(size=(bn, dim)) * scale).astype(np.float32)
    q = (rng.normal(size=(n_q, dim)) * scale).astype(np.float32)
    q[:16] = s[:16]                                   # d_coarse ≈ 0
    q[16:24] = s[16:24] * np.float32(1.0 + 1e-6)
    qr = quantize_rows(s, bn)
    qi, qsc, qe = (torch.from_numpy(np.array(x))
                   for x in quantize_queries_np(q))
    si = torch.from_numpy(qr.q)
    ssc = torch.full((bn,), float(qr.scales[0]), dtype=torch.float32)
    seps = torch.from_numpy(qr.eps.astype(np.float32))
    live = torch.from_numpy(rng.random(bn) >= 0.2)
    d2, lb, q2, s2 = _chain(qi, qsc, qe, si, ssc, seps)
    seps_max = torch.clamp(seps[live], min=0).max()
    s2_max = torch.clamp(s2[live], min=0).max()
    up = torch.full((n_q,), float("inf"))
    down = torch.full((n_q,), float("-inf"))
    at = lb[torch.arange(n_q), torch.as_tensor(rng.integers(0, bn, n_q))]
    kth = torch.sort(lb[:, live], 1).values[:, 5]
    cuts = [at, torch.nextafter(at, up), torch.nextafter(at, down), kth,
            torch.nextafter(kth, up), torch.nextafter(kth, down), up, down,
            torch.zeros(n_q), torch.full((n_q,), float(lb.max()))]
    dropped_any = False
    for cut in cuts:
        t = kq.screen_limit_plain(cut, qe, q2, seps_max, s2_max)
        drop = (d2 > t[:, None]) & live[None, :]
        bad = drop & ~((lb > cut[:, None]) | torch.isnan(lb))
        assert not bool(bad.any()), (
            f"screen dropped {int(bad.sum())} pairs with lb <= cut")
        # what it keeps includes every pair at the cut
        at_cut = (lb == cut[:, None]) & live[None, :]
        assert not bool((drop & at_cut).any())
        dropped_any |= bool(drop.any())
    # the screen is not vacuous, unless ε_s overflowed float16 (scale
    # 1e12: every lb is 0, and nothing may be dropped)
    assert dropped_any == bool(torch.isfinite(seps_max))
    # θ = -inf (a padding query) drops every pair with a number d2 (with
    # finite ε_s; an infinite ε_s makes T = +inf: nothing dropped, sound)
    t = kq.screen_limit_plain(down, qe, q2, seps_max, s2_max)
    assert bool(((d2 > t[:, None]) | torch.isnan(d2)).all()) \
        == bool(torch.isfinite(seps_max))
    # θ = +inf keeps every pair
    t = kq.screen_limit_plain(up, qe, q2, seps_max, s2_max)
    assert not bool((d2 > t[:, None]).any())


def test_screen_passes_nan_to_the_chain():
    """A NaN d2 is never dropped by the screen, whatever T is: the chain
    decides it (its lb is NaN, which no run keeps), as before the screen
    existed."""
    t = kq.screen_limit_plain(
        torch.tensor([1.0, 0.0, float("inf"), float("-inf")]),
        torch.zeros(4), torch.ones(4), torch.tensor(0.0), torch.tensor(1.0))
    assert bool(torch.isfinite(t[:2]).all()) and t[2] == float("inf") \
        and t[3] == float("-inf")
    assert not bool((torch.full((4,), float("nan")) > t).any())


# ---- (d) the plain versions against the JAX package at the new form
# boundaries


@pytest.mark.parametrize("d", [31, 32, 33])
def test_dense_plain_matches_pallas_interpret_at_form_cut(d):
    """d = 32 is K-D's widest narrow form, 33 its narrowest tile form."""
    rng = np.random.default_rng(d)
    r = rng.normal(size=(40, d)).astype(np.float32)
    s = rng.normal(size=(300, d)).astype(np.float32)
    s[200] = s[17]
    r[3] = s[17]
    k = 9
    jd, ji = distance_topk_pallas(jnp.asarray(r), jnp.asarray(s), k, bm=32,
                                  bn=128, interpret=True)
    pd, pi = kd.distance_topk_plain(torch.from_numpy(r), torch.from_numpy(s),
                                    k, bm=32, bn=128)
    rows = np.concatenate([r, s])
    jd, ji = np.asarray(jd), np.asarray(ji)
    assert_d_close(pd.numpy(), jd, rows)
    atol = 2.0 ** -18 * 2 * float((rows.astype(np.float64) ** 2)
                                  .sum(1).max())
    mism = pi.numpy() != ji
    assert (np.abs(pd.numpy()[mism].astype(np.float64) ** 2
                   - jd[mism].astype(np.float64) ** 2) <= atol).all()


def _allowance(qi, qscale, si, sscale):
    q2 = (qscale.astype(np.float64) ** 2
          * (qi.astype(np.float64) ** 2).sum(1))[:, None]
    s2 = (sscale.astype(np.float64) ** 2
          * (si.astype(np.float64) ** 2).sum(1))[None, :]
    c = qi.astype(np.float64) @ si.astype(np.float64).T
    dc = np.sqrt(np.maximum(q2 + s2 - 2 * (qscale[:, None] * sscale[None, :])
                            * c, 0.0))
    delta = kq.NUM_DELTA_REL * (q2 + s2)
    return 2 * delta / np.maximum(dc, np.sqrt(delta)) + 1e-6


@pytest.mark.parametrize("mp,dim", [(512, 10), (1024, 10), (512, 33)])
def test_sched_plain_matches_jax_at_run_widths(mp, dim):
    """mp = 512 is K-Q's widest shared-memory run, 1,024 a wide run; the
    schedule walk against the JAX package's ``ref_sched``, θ = +inf so
    the runs fill."""
    args, sched, counts = _coarse_case(mp + dim, n_r=64, n_s=1280, dim=dim)
    args[3] = torch.full_like(args[3], float("inf"))
    lb, pos = kq.quant_coarse_sched_plain(*args, mp, sched, counts, bm=32,
                                          bn=64)
    np_args = [a.numpy() for a in args]
    jlb, jpos = jops.quant_coarse_topk(*np_args, mp, schedule=sched.numpy(),
                                       counts=counts.numpy(), bm=32, bn=64,
                                       impl="ref_sched")
    jlb, jpos = np.asarray(jlb), np.asarray(jpos)
    allowance = float(_allowance(np_args[0], np_args[1], np_args[4],
                                 np.repeat(np_args[5], 64)).max())
    lb, pos = lb.numpy(), pos.numpy()
    fin = np.isfinite(jlb)
    assert (np.isfinite(lb) == fin).all() and fin.sum() > mp
    assert (np.abs(lb[fin].astype(np.float64) - jlb[fin]) <= allowance).all()
    mism = pos != jpos
    assert (np.abs(lb[mism].astype(np.float64) - jlb[mism])
            <= allowance).all()
