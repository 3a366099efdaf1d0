"""How the CUDA kernels K-F and K-G cut their work, held on the CPU.

K-G (``csrc/gather_topk.cu``) cuts each R tile's schedule row into
contiguous visit ranges and merges the ranges' partial runs; K-F
(``csrc/flash_attn.cu``) splits the keys of a decode step across blocks
and combines the partial softmax states, and on the tensor cores splits
each float32 p into three bf16 terms. The kernels run only on a card;
here their plain models (``tests/torch_parity.py``) and their host-side
planners are held against the unsplit plain versions and against the JAX
package's Pallas kernels in interpret mode, on numpy-seeded inputs.

Tolerances: K-G's cut is exact (a total order on unique positions), so
bit for bit. K-F's split-KV and any-width plain version: the tolerances
of ``tests/test_torch_flash_attention.py`` (float32 within 1e-5 abs of
the interpret kernel: the same online softmax, sums in another order).
The three-term split: exact."""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import distance_topk as kg  # noqa: E402
from repro_torch.kernels import flash_attention as kf  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from torch_parity import flash_split_kv, gather_split_plain, split_p3  # noqa: E402

F32_ATOL = 1e-5


def _gather_case(seed, nr=150, ns=14 * 64, dim=6, bm=32, bn=64, dead=0.2):
    """Rows with duplicates (every row of the second half repeats one of
    the first: ties in d²), ~``dead`` of them dead, and a random
    ascending schedule per R tile over all 14 S tiles."""
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(ns, dim)).astype(np.float32)
    s[ns // 2:] = s[rng.integers(0, ns // 2, ns - ns // 2)]
    r = rng.normal(size=(nr, dim)).astype(np.float32)
    r[:10] = s[:10]                       # queries on a row: d² = 0 ties
    alive = (rng.random(ns) >= dead).astype(np.float32)
    nr_t, ns_t = -(-nr // bm), -(-ns // bn)
    counts = rng.integers(1, ns_t + 1, nr_t)
    sched = np.zeros((nr_t, ns_t), np.int32)
    for t in range(nr_t):
        picks = np.sort(rng.choice(ns_t, counts[t], replace=False))
        sched[t, :counts[t]], sched[t, counts[t]:] = picks, picks[-1]
    return (torch.from_numpy(r), torch.from_numpy(s), torch.from_numpy(sched),
            torch.from_numpy(counts.astype(np.int32)), torch.from_numpy(alive))


# ---- (a) K-G: the split schedule and its merge are bit for bit the unsplit
# plain version


@pytest.mark.parametrize("k", [5, 10, 40])
@pytest.mark.parametrize("splits", [1, 2, 7, 14])
def test_gather_split_merge_is_bitwise_unsplit(k, splits):
    r, s, sched, counts, alive = _gather_case(k)
    max_visits = sched.shape[1]
    assert max_visits == 14
    plan = kg.plan_gather(r.shape[0], r.shape[1], k, 32, max_visits,
                          splits=splits)
    assert plan.splits == splits
    kw = dict(alive=alive, bm=32, bn=64)
    want_d, want_p = kg.distance_topk_gather_plain(r, s, k, sched, counts,
                                                   **kw)
    got_d, got_p = gather_split_plain(r, s, k, sched, counts, plan, **kw)
    assert torch.equal(got_d.view(torch.int32), want_d.view(torch.int32))
    assert torch.equal(got_p, want_p)
    # the duplicates do tie: some run holds two rows at one distance
    fin = torch.isfinite(want_d)
    assert bool(((want_d[:, 1:] == want_d[:, :-1]) & fin[:, 1:]).any())


# ---- (b) the host-side planners


@pytest.mark.parametrize("n_r,d,k,bm,max_visits", [
    (4096, 10, 16, 128, 1135),   # a Forest bucket
    (8, 32, 8, 128, 2048),       # a kNN-LM decode step
    (4096, 256, 10, 128, 128),   # past d = 128 (the general kernel)
    (4096, 10, 1024, 128, 1135), # past k = 64
    (100, 10, 10, 128, 1),       # one visit
    (1, 3, 1, 1, 70000),         # more visits than a grid axis holds
])
def test_gather_planner_covers_every_visit_once(n_r, d, k, bm, max_visits):
    assert all(p.annotation in (int, "int", "Optional[int]")
               for p in inspect.signature(kg.plan_gather).parameters.values())
    for splits in (None, 1, 3, 10 ** 6):
        plan = kg.plan_gather(n_r, d, k, bm, max_visits, splits=splits)
        assert 1 <= plan.splits <= 65535 and plan.per >= 1
        covered = np.zeros(max_visits, np.int64)
        for i in range(plan.splits):
            covered[i * plan.per:(i + 1) * plan.per] += 1
        assert (covered == 1).all()
        assert (plan.splits - 1) * plan.per < max_visits  # no empty split
        qw = 2 if k <= 16 and d <= 32 else 1
        warps = 16 if qw == 2 and min(n_r, bm) >= 32 else 8
        assert (plan.warps, plan.qw) == (warps, qw)
    # a decode batch of one R tile spreads over many blocks
    if n_r <= bm and max_visits >= 528:
        assert kg.plan_gather(n_r, d, k, bm, max_visits).splits >= 264


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("b,nq,nk,h,kvh,d", [
    (8, 2048, 2048, 24, 8, 128),   # the LM prefill
    (8, 1, 2080, 24, 8, 128),      # the LM decode step
    (2, 1, 4096, 6, 2, 80),
    (1, 7, 0, 2, 1, 16),           # no key at all
    (3, 300, 300, 4, 4, 320),
    (1, 1, 100000, 1, 1, 192),
])
def test_attention_planner_covers_every_key_once(bf16, b, nq, nk, h, kvh, d):
    assert all(p.annotation in (int, bool, "int", "bool")
               for p in inspect.signature(kf.plan_attention)
               .parameters.values())
    plan = kf.plan_attention(bf16, b, nq, nk, h, kvh, d)
    assert plan.splits >= 1 and plan.zc >= 1
    covered = np.zeros(nk, np.int64)
    for i in range(plan.splits):
        covered[i * plan.split_keys:(i + 1) * plan.split_keys] += 1
    assert (covered == 1).all()
    assert (plan.splits - 1) * plan.split_keys < max(nk, 1)
    # every output column in exactly one chunk
    assert (plan.zc - 1) * min(plan.width, 128) < d <= plan.zc * min(
        plan.width, 128)
    if plan.route == "mma":
        assert bf16 and d <= 256 and plan.splits == 1 and plan.width >= d
    else:
        assert plan.split_keys % 128 == 0 and plan.width in (16, 32, 64, 128)
    if nq == 1:   # decode: ≥ 2 blocks per SM of an H100 where the keys allow
        blocks = -(-(h // kvh) * nq // plan.bq) * b * kvh * plan.zc
        assert blocks * plan.splits >= min(2 * 132, blocks * -(-nk // 128))


# ---- (c) K-F's split-KV and its combine against the interpret kernel


def _attn(b, nq, nk, h, kvh, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, nq, h, d)).astype(np.float32),
            rng.normal(size=(b, nk, kvh, d)).astype(np.float32),
            rng.normal(size=(b, nk, kvh, d)).astype(np.float32))


@pytest.mark.parametrize("nq,nk,window,split_keys", [
    (1, 700, None, 128),      # a decode step in 6 splits
    (1, 700, 100, 256),       # windowed: most splits see none of the keys
    (5, 333, None, 128),
    (20, 7, None, 128),       # rows before the first key see nothing
])
def test_split_kv_combine_matches_pallas_interpret(nq, nk, window,
                                                   split_keys):
    q, k, v = _attn(2, nq, nk, 6, 2, 32, nq + nk)
    got, m = flash_split_kv(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), split_keys, window=window)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), window=window,
                                  interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_ATOL)
    if window is not None:   # some split saw no key of a row: it dropped out
        assert bool((m == -1e30).any())
    if nq > nk:              # a row that sees no key comes out 0, not NaN
        assert bool((got[:, :nq - nk] == 0).all())
        assert bool(torch.isfinite(got).all())


# ---- (d) the three-term bf16 split of p is exact


def test_three_term_split_reconstructs_p_exactly():
    rng = np.random.default_rng(16)
    p = np.concatenate([
        [0.0, 1.0, 2.0 ** -126, np.nextafter(np.float32(1), np.float32(0))],
        2.0 ** rng.uniform(-126, 0, 20000),
        rng.random(20000)]).astype(np.float32)
    pt = torch.from_numpy(p)
    hi, mid, lo = split_p3(pt)
    want = pt.double() * 2.0 ** 32
    assert torch.equal(hi.double() + mid.double() + lo.double(), want)
    # in float32 too, added as the tensor cores' fp32 accumulator would
    assert torch.equal((lo.float() + mid.float()) + hi.float(),
                       pt * 2.0 ** 32)
    # a two-term split would round p
    assert not torch.equal(hi.double() + mid.double(), want)
    assert bool((hi[0] == 0) & (mid[0] == 0) & (lo[0] == 0))


# ---- (e) any head width on the CPU route


@pytest.mark.parametrize("d", [80, 192, 320])
@pytest.mark.parametrize("nq,nk,window", [(40, 72, None), (1, 300, 50)])
def test_any_head_width_matches_pallas_interpret(d, nq, nk, window):
    q, k, v = _attn(2, nq, nk, 4, 2, d, d + nq)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), window=window).numpy()
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), window=window,
                                  interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=F32_ATOL)
    plan = kf.plan_attention(True, 2, nq, nk, 4, 2, d)
    assert plan.zc * min(plan.width, 128) >= d
