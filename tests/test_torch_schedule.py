"""Port vs JAX package: the device tile schedule (Thm-2 tile stats,
Cor. 1 + Thm 2 visit mask, prefix compaction) fed identical float
inputs gives equal int and bool arrays; the port's visit mask, made
sound, a superset of JAX's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import schedule as jsched  # noqa: E402

from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core.bounds import pad_theta  # noqa: E402


@pytest.mark.parametrize("n_s,m,bn,seed", [(1000, 12, 64, 0),
                                           (777, 5, 128, 1),
                                           (64, 3, 64, 2)])
def test_segment_tile_stats_equal(n_s, m, bn, seed):
    rng = np.random.default_rng(seed)
    part = np.sort(rng.integers(0, m, n_s)).astype(np.int32)
    part[rng.random(n_s) < 0.05] = -1            # padding rows
    dist = rng.random(n_s).astype(np.float32) * 4
    want = jsched.segment_tile_stats(part, dist, m, bn)
    got = tsched.segment_tile_stats(torch.from_numpy(part),
                                    torch.from_numpy(dist), m, bn)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def _schedule_inputs(seed, b=128, m=10, ns_tiles=24, bm=32):
    rng = np.random.default_rng(seed)
    qp = (rng.random((b, m)) * 5).astype(np.float32)
    home = qp.argmin(1).astype(np.int32)
    valid = np.arange(b) < b - 7                 # a ragged bucket
    th = np.where(valid, rng.random(b) * 0.3, -np.inf).astype(np.float32)
    piv = rng.normal(size=(m, 3))
    pivd = np.sqrt(((piv[:, None] - piv[None]) ** 2).sum(-1)).astype(
        np.float32)
    sd_min = (rng.random((ns_tiles, m)) * 4).astype(np.float32)
    sd_max = sd_min + (rng.random((ns_tiles, m)) * 0.2).astype(np.float32)
    present = rng.random((ns_tiles, m)) < 0.2
    sd_min[~present], sd_max[~present] = np.inf, -np.inf
    return qp, home, th, valid, pivd, sd_min, sd_max, present, bm


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_visit_mask_and_compaction_equal(seed):
    args = _schedule_inputs(seed)
    *arrs, bm = args
    want_visit = np.array(jsched.visit_mask_jnp(*arrs, bm=bm))
    # the port's mask is the sound form (ROADMAP C15): with no assignment
    # excess it visits every tile JAX's does, and prunes all the same
    excess = torch.zeros((arrs[0].shape[1],), dtype=torch.float64)
    got_visit = tsched.visit_mask(*map(torch.from_numpy, arrs), excess,
                                  bm=bm).numpy()
    assert not (want_visit & ~got_visit).any()
    assert 0 < want_visit.mean() <= got_visit.mean() < 1
    ws, wc = jsched.compact_visits_jnp(jax.numpy.asarray(want_visit))
    gs, gc = tsched.compact_visits(torch.from_numpy(want_visit))
    assert gs.dtype == torch.int32 and gc.dtype == torch.int32
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


def test_compaction_rows_ascending_with_fallback():
    visit = np.zeros((4, 9), bool)
    visit[0, [2, 5, 7]] = True
    visit[2, :] = True
    sched, cnt = tsched.compact_visits(torch.from_numpy(visit))
    np.testing.assert_array_equal(cnt.numpy(), [3, 1, 9, 1])
    np.testing.assert_array_equal(sched[0].numpy(), [2, 5, 7] + [7] * 6)
    np.testing.assert_array_equal(sched[1].numpy(), [0] * 9)   # fallback
    np.testing.assert_array_equal(sched[2].numpy(), np.arange(9))


def test_pad_theta_matches_jax():
    from repro.core.bounds import pad_theta as j_pad
    th = np.array([0.0, 1e-3, 1.5, 700.0, np.inf, -np.inf], np.float32)
    np.testing.assert_array_equal(pad_theta(torch.from_numpy(th)).numpy(),
                                  np.asarray(j_pad(th)))
