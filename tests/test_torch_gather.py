"""Port vs JAX package: the plain version of the scheduled gather top-k
kernel (K-G) against the Pallas gather kernel in interpret mode, on
pruned random schedules with alive masks, and the id-dedup run merge."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.distance_topk import distance_topk_gather_pallas  # noqa: E402
from repro.kernels.sorted_merge import merge_sorted_runs_unique as j_merge  # noqa: E402

from repro_torch.kernels import distance_topk as kg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.sorted_merge import merge_sorted_runs_unique  # noqa: E402

# the two compute the same expanded d² with different summation orders
# (XLA dot vs torch bmm) on unit-scale Gaussian rows: 1e-4 absolute in √d²
ATOL = 1e-4


def _random_schedule(rng, nr_t, ns_t):
    """Ragged visit lists, >= 1 tile each, ascending, repeat-last pad."""
    counts = rng.integers(1, ns_t + 1, nr_t)
    sched = np.zeros((nr_t, int(counts.max())), np.int32)
    for t in range(nr_t):
        picks = np.sort(rng.choice(ns_t, counts[t], replace=False))
        sched[t, :counts[t]] = picks
        sched[t, counts[t]:] = picks[-1]
    return sched, counts.astype(np.int32)


@pytest.mark.parametrize("nr,ns,dim,k,seed,dead", [
    (96, 300, 6, 5, 0, 0.0),
    (50, 500, 3, 9, 1, 0.2),
    (128, 640, 12, 16, 2, 0.5),
    (64, 320, 5, 8, 3, 0.95),     # live rows run short: (+inf, -1) slots
])
def test_gather_plain_matches_pallas_interpret(nr, ns, dim, k, seed, dead):
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(nr, dim)).astype(np.float32)
    s = rng.normal(size=(ns, dim)).astype(np.float32)
    alive = (rng.random(ns) >= dead).astype(np.float32)
    bm, bn = 32, 64
    sched, counts = _random_schedule(rng, -(-nr // bm), -(-ns // bn))
    jd, ji = distance_topk_gather_pallas(
        jnp.asarray(r), jnp.asarray(s), k, jnp.asarray(sched),
        jnp.asarray(counts), alive=jnp.asarray(alive), bm=bm, bn=bn,
        interpret=True)
    jd, ji = np.asarray(jd), np.asarray(ji)
    td, ti = ops.distance_topk_gather(
        torch.from_numpy(r), torch.from_numpy(s), k,
        torch.from_numpy(sched), torch.from_numpy(counts),
        alive=torch.from_numpy(alive), bm=bm, bn=bn)
    td, ti = td.numpy(), ti.numpy()
    assert ti.dtype == np.int32 and td.shape == (nr, k)
    fin = np.isfinite(jd)
    assert (np.isfinite(td) == fin).all()
    np.testing.assert_allclose(td[fin], jd[fin], atol=ATOL)
    np.testing.assert_array_equal(ti[fin], ji[fin])
    assert (ti[~fin] == -1).all()
    assert not np.isin(ti[fin], np.where(alive == 0)[0]).any()


def test_gather_plain_ties_go_to_the_lower_position():
    """Duplicate rows tie exactly in d²: the lower packed position wins."""
    rng = np.random.default_rng(4)
    base = rng.normal(size=(40, 4)).astype(np.float32)
    s = np.concatenate([base, base, base])          # rows i, i+40, i+80
    r = base[:16] + 0.01
    sched = np.array([[0, 1]], np.int32)
    counts = np.array([2], np.int32)
    _, ti = kg.distance_topk_gather_plain(
        torch.from_numpy(r), torch.from_numpy(s), 3,
        torch.from_numpy(sched), torch.from_numpy(counts), bm=16, bn=64)
    np.testing.assert_array_equal(ti[:, 0].numpy(), np.arange(16))
    np.testing.assert_array_equal(ti[:, 1].numpy(), np.arange(16) + 40)
    np.testing.assert_array_equal(ti[:, 2].numpy(), np.arange(16) + 80)


def test_gather_plain_walks_only_scheduled_slots():
    """Slots at or past counts[i] are dead even where the schedule names
    a tile (compaction repeats the last entry there)."""
    rng = np.random.default_rng(5)
    r = rng.normal(size=(32, 4)).astype(np.float32)
    s = rng.normal(size=(256, 4)).astype(np.float32)
    sched = np.array([[1, 3, 0, 2], [2, 2, 2, 2]], np.int32)
    counts = np.array([2, 1], np.int32)
    _, ti = kg.distance_topk_gather_plain(
        torch.from_numpy(r), torch.from_numpy(s), 8,
        torch.from_numpy(sched), torch.from_numpy(counts), bm=16, bn=64)
    tiles = ti.numpy() // 64
    assert np.isin(tiles[:16], [1, 3]).all()
    assert (tiles[16:] == 2).all()


def test_merge_sorted_runs_unique_matches_jax():
    """Runs with overlapping ids: each id kept once, at its smaller
    distance, the kp smallest ascending."""
    rng = np.random.default_rng(6)
    n, kp = 40, 16
    ad = np.sort(rng.random((n, kp)).astype(np.float32), 1)
    bd = np.sort(rng.random((n, kp)).astype(np.float32), 1)
    ai = rng.permutation(1000)[:n * kp].reshape(n, kp).astype(np.int32)
    bi = rng.permutation(1000)[:n * kp].reshape(n, kp).astype(np.int32)
    bi[:, ::3] = ai[:, ::3]                           # shared ids
    bd[:, ::3] = ad[:, ::3]                           # same row, same dist
    ad[5:, -4:], ai[5:, -4:] = np.inf, -1             # padded tails
    jd, ji = j_merge(jnp.asarray(ad), jnp.asarray(ai), jnp.asarray(bd),
                     jnp.asarray(bi))
    td, ti = merge_sorted_runs_unique(
        torch.from_numpy(ad), torch.from_numpy(ai.astype(np.int64)),
        torch.from_numpy(bd), torch.from_numpy(bi.astype(np.int64)))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    fin = ti.numpy()[np.isfinite(td.numpy())]
    assert all(len(set(row)) == len(row) for row in
               [r[r >= 0] for r in ti.numpy()])
    assert fin.size
