"""How the CUDA kernel K-A (nearest pivot) cuts its work, held on the CPU.

K-A (``csrc/assign.cu``) runs in one of two forms that
``kernels.assign.plan_assign`` picks from the static shapes, and may cut
the pivots into contiguous ranges across blocks whose (d², id) minima fold
as 64-bit keys (d² bits << 32) | id under a minimum; inside a tile-form
block each of 16 threads keeps the minimum over every 16th pivot and the
16 combine in the same order. The kernel runs only on a card; here its
planner and a plain model of those folds (``tests/torch_parity.py``) are
held against the unsplit plain version, and the plain version against the
JAX package's Pallas kernel in interpret mode at the form cut (d = 32 /
33) and with duplicated pivots, on numpy-seeded inputs.

Tolerances: the folds are exact (a total order on unique ids), so bit for
bit. Across the two packages ids are equal and distances within
``ULP_BOUND`` (4) float32 ulps: the packages sum d² in different orders
(ROADMAP Queue C1)."""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.assign import assign_pallas  # noqa: E402
from repro_torch.kernels import assign as ka  # noqa: E402

from torch_parity import ULP_BOUND, assign_split_plain, ulps  # noqa: E402


def _covered(m, splits, per):
    covered = np.zeros(m, np.int64)
    for i in range(splits):
        covered[i * per:(i + 1) * per] += 1
    return covered


# ---- (a) the planner covers every pivot exactly once


@pytest.mark.parametrize("n,m,d", [
    (581012, 256, 10),     # the Forest build
    (65536, 256, 3072),    # phase 13's wide shape
    (1048576, 128, 32),    # the LM datastore build, the narrow form's widest
    (1900, 256, 10),       # a quantized fallback batch
    (4097, 257, 32),
    (4097, 257, 33),       # the tile form's narrowest
    (1023, 1, 32),
    (1023, 1, 33),
    (1, 257, 31),
    (1, 257, 33),
    (1, 1, 1),
    (4097, 5000, 10),      # more pivots than one split's shared memory
    (4097, 5000, 32),
])
def test_assign_planner_covers_every_pivot_once(n, m, d):
    assert all(p.annotation in ("int", "Optional[int]", "Optional[str]")
               for p in inspect.signature(ka.plan_assign).parameters.values())
    want_form = "narrow" if d <= 32 else "tile"
    forms = ("narrow", "tile") if d <= 32 else ("tile",)
    for form in (None,) + forms:
        for splits in (None, 1, 2, 3, 7, 10 ** 6):
            plan = ka.plan_assign(n, m, d, form=form, splits=splits)
            assert plan.form == (form or want_form)
            assert plan.rows == (128 if plan.form == "tile"
                                 else 32 * (4 if d <= 16 else 2))
            assert 1 <= plan.splits <= 65535 and plan.per >= 1
            assert (_covered(m, plan.splits, plan.per) == 1).all()
            assert (plan.splits - 1) * plan.per < m    # no empty split
            if plan.form == "tile":     # whole pivot tiles a split
                assert plan.per % 128 == 0
                assert splits is None or plan.splits <= splits
            else:     # ranges of any size, as many as shared memory holds
                cap = ka._narrow_shape(d)[1]
                assert plan.per <= cap
                if splits is not None:
                    assert plan.per == min(-(-m // min(splits, m)), cap)
    with pytest.raises(ValueError):
        ka.plan_assign(n, m, 33, form="narrow")
    with pytest.raises(ValueError):
        ka.plan_assign(n, m, d, form="wide")


def test_assign_planner_fills_the_card():
    # many rows: one split; few rows: the pivots cut across blocks
    assert ka.plan_assign(581012, 256, 10).splits == 1
    assert ka.plan_assign(1048576, 128, 32).splits == 1
    assert ka.plan_assign(65536, 256, 3072).splits == 1
    few = ka.plan_assign(1024, 256, 10)
    assert few.splits > 1 and few.per >= 8
    assert ka.plan_assign(300, 1024, 64).splits == 8     # one tile a split
    # the narrow form's shared memory: 945 pivots of stride 12 a split
    assert ka.plan_assign(581012, 5000, 10) == ka.AssignPlan("narrow", 128,
                                                             6, 945)


# ---- (b) the folds of the cut are the unsplit plain version, bit for bit


def _ties(seed, n, m, d):
    """Gaussian rows and pivots, later pivots copies of earlier ones (so
    ties fall across every cut), a few rows copies of pivots (d² = 0)."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(m, d)).astype(np.float32)
    if m > 1:
        p[m // 2:] = p[rng.integers(0, m // 2, m - m // 2)]
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:8] = p[rng.integers(0, m, 8)]
    return torch.from_numpy(x), torch.from_numpy(p)


@pytest.mark.parametrize("form", ["narrow", "tile"])
@pytest.mark.parametrize("splits", [1, 2, 3, 7, 40, 300])
@pytest.mark.parametrize("m,d", [(257, 10), (300, 32), (1, 4)])
def test_assign_split_fold_is_bitwise_unsplit(form, splits, m, d):
    x, p = _ties(splits + m + d, 500, m, d)
    plan = ka.plan_assign(x.shape[0], m, d, form=form, splits=splits)
    ranges = [np.arange(i * plan.per, min(m, (i + 1) * plan.per))
              for i in range(plan.splits)]
    if form == "tile":      # every 16th pivot of each tile of a range
        ranges = [r[r % 16 == c] for r in ranges for c in range(16)]
        ranges = [r for r in ranges if r.size]
    want_p, want_d = ka.assign_plain(x, p)
    got_p, got_d = assign_split_plain(x, p, ranges)
    assert torch.equal(got_p, want_p)
    assert torch.equal(got_d.view(torch.int32), want_d.view(torch.int32))
    if m > 1:               # the copies did tie: the lowest id won
        twins = [(i, j) for j in range(m // 2, m) for i in range(m // 2)
                 if torch.equal(p[j], p[i])]
        picked = set(want_p.tolist())
        assert not picked & {j for _, j in twins}
        assert picked & {i for i, _ in twins}


# ---- (c) the plain version against the JAX kernel at the form cut


@pytest.mark.parametrize("d", [32, 33])
@pytest.mark.parametrize("dups", [False, True])
def test_assign_plain_matches_pallas_at_the_form_cut(d, dups):
    rng = np.random.default_rng(d)
    n, m = 300, 64
    x = rng.normal(size=(n, d)).astype(np.float32)
    p = rng.normal(size=(m, d)).astype(np.float32)
    later = np.arange(0)
    if dups:                # exact ties, across the kernel's pivot tiles
        p[40:50] = p[0:10]
        p[63] = p[5]
        later = np.r_[np.arange(40, 50), 63]
    jpid, jdist = assign_pallas(x, p, bm=32, bp=8, interpret=True)
    tpid, tdist = ka.assign_plain(torch.from_numpy(x), torch.from_numpy(p),
                                  block=64)
    np.testing.assert_array_equal(tpid.numpy(), np.asarray(jpid))
    assert not np.isin(tpid.numpy(), later).any()    # the lowest id wins
    assert ulps(tdist.numpy(), np.asarray(jdist)).max() <= ULP_BOUND
    if dups:                # some rows did pick a duplicated pivot
        assert np.isin(tpid.numpy(), np.r_[np.arange(10), 5]).any()
