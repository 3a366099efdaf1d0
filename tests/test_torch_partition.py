"""Port vs JAX package: pivot selection, nearest-pivot assignment (the
K-A kernel's plain version vs the Pallas kernel in interpret mode), the
summary table and the build-once index. Inputs are made with numpy and
fed to both; the port runs on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import JoinConfig as JConfig  # noqa: E402
from repro.core import build_index as j_build_index  # noqa: E402
from repro.core.partition import assign_and_summarize as j_ass  # noqa: E402
from repro.core.pivots import select_pivots as j_select  # noqa: E402
from repro.kernels.assign import assign_pallas  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.core import partition as tpart  # noqa: E402
from repro_torch.core.pivots import select_pivots as t_select  # noqa: E402
from repro_torch.kernels import assign as ka  # noqa: E402

# distances: the two packages sum d² = ‖x‖²+‖p‖²−2x·p in different
# orders (XLA's and torch's CPU matmuls). Compared as d², within 2^-18
# (32 fp32 ulps) of the largest ‖x‖²+‖p‖² — in d, √ would blow a
# rounding residue of a row sitting on its pivot up to ~1e-3.
RTOL = 1e-5


def assert_d_close(got, want, rows):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all()
    atol = 2.0 ** -18 * 2 * float((np.asarray(rows, np.float64) ** 2)
                                  .sum(1).max())
    np.testing.assert_allclose(got[fin] ** 2, want[fin] ** 2, rtol=RTOL,
                               atol=atol)


def _index_arrays(jidx):
    return {"pivots": jidx.pivots, "pivd": jidx.pivd, "s_part": jidx.s_part,
            "s_dist": jidx.s_dist, "t_s.counts": jidx.t_s.counts,
            "t_s.lower": jidx.t_s.lower, "t_s.upper": jidx.t_s.upper,
            "t_s.knn_dists": jidx.t_s.knn_dists, "s_order": jidx.s_order,
            "s_sorted": jidx.s_sorted, "s_part_sorted": jidx.s_part_sorted,
            "s_dist_sorted": jidx.s_dist_sorted,
            "s_ids_sorted": jidx.s_ids_sorted, "s_inv": jidx.s_inv}


@pytest.mark.parametrize("n,m,dim", [(100, 16, 6), (257, 50, 12),
                                     (64, 7, 3)])
def test_assign_plain_matches_pallas_interpret(n, m, dim):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    p = rng.normal(size=(m, dim)).astype(np.float32)
    jpid, jdist = assign_pallas(x, p, bm=32, bp=8, interpret=True)
    tpid, tdist = ka.assign_plain(torch.from_numpy(x), torch.from_numpy(p),
                                  block=64)
    assert tpid.dtype == torch.int32
    np.testing.assert_array_equal(tpid.numpy(), np.asarray(jpid))
    assert_d_close(tdist.numpy(), jdist, np.concatenate([x, p]))


@pytest.mark.parametrize("strategy", ["random", "farthest", "kmeans"])
def test_select_pivots_matches_jax(strategy):
    """Same numpy draw order → the same candidate sets and pivots."""
    data = rt.forest_like(2000, 6, seed=5)
    jp = j_select(data, 24, strategy, sample=500, n_sets=4, seed=3)
    tp = t_select(data, 24, strategy, sample=500, n_sets=4, seed=3,
                  device="cpu")
    if strategy == "kmeans":     # ten Lloyd steps of float32 sums
        np.testing.assert_allclose(tp, jp, rtol=1e-4, atol=1e-3)
    else:
        np.testing.assert_array_equal(tp, jp)


@pytest.mark.parametrize("data", ["gaussian", "forest"])
def test_assign_and_summarize_matches_jax(data):
    if data == "gaussian":
        x = np.random.default_rng(6).normal(size=(1500, 8)).astype(np.float32)
    else:
        x = rt.forest_like(1500, 10, seed=6)
    piv = x[np.random.default_rng(7).choice(x.shape[0], 24, replace=False)]
    jpid, jdist, jt, jorder = j_ass(x, piv, k=5, return_order=True)
    tpid, tdist, tt, torder = tpart.assign_and_summarize(
        torch.from_numpy(x), torch.from_numpy(piv), k=5, return_order=True)
    np.testing.assert_array_equal(tpid.numpy(), jpid)
    assert_d_close(tdist.numpy(), jdist, x)
    np.testing.assert_array_equal(tt.counts.numpy(), jt.counts)
    for f in ("lower", "upper", "knn_dists"):
        assert_d_close(getattr(tt, f).numpy(), getattr(jt, f), x)
    if data == "gaussian":     # forest rows tie exactly; order may differ
        np.testing.assert_array_equal(torder.numpy(), jorder)


@pytest.mark.parametrize("n_s,dim,m,bn", [(1200, 8, 16, 64),
                                          (3000, 16, 32, 128)])
def test_build_index_matches_jax(n_s, dim, m, bn):
    """Given the same pivots: part ids, T_S, pivd, the packing and the
    per-tile Thm-2 stats agree."""
    rng = np.random.default_rng(n_s)
    s = rng.normal(size=(n_s, dim)).astype(np.float32) * 5 + 3
    piv = s[rng.choice(n_s, m, replace=False)]
    jidx = j_build_index(s, JConfig(k=6, n_pivots=m), pivots=piv)
    tidx = rt.build_index(s, rt.JoinConfig(k=6, n_pivots=m), pivots=piv,
                          device="cpu")
    np.testing.assert_array_equal(tidx.s_part.numpy(), jidx.s_part)
    np.testing.assert_array_equal(tidx.t_s.counts.numpy(), jidx.t_s.counts)
    for f in ("lower", "upper", "knn_dists"):
        assert_d_close(getattr(tidx.t_s, f).numpy(), getattr(jidx.t_s, f), s)
    # pivd: float64 in both, then cast — equal up to one float32 rounding
    np.testing.assert_allclose(tidx.pivd.numpy(), jidx.pivd, rtol=1e-6,
                               atol=1e-6)
    assert_d_close(tidx.s_dist.numpy(), jidx.s_dist, s)
    for f in ("s_order", "s_part_sorted", "s_ids_sorted", "s_inv"):
        np.testing.assert_array_equal(getattr(tidx, f).numpy(),
                                      getattr(jidx, f))
    np.testing.assert_array_equal(tidx.s_sorted.numpy(), jidx.s_sorted)
    # per-tile stats over the same packing: which partitions each tile
    # holds is equal; the min/max |p, s| carry the distances' rounding
    # (tests/test_torch_schedule.py holds them equal on equal inputs)
    (t_min, t_max, t_pres), (j_min, j_max, j_pres) = (
        tidx.tile_stats(bn), jidx.tile_stats(bn))
    np.testing.assert_array_equal(t_pres.numpy(), j_pres)
    assert_d_close(np.where(j_pres, t_min.numpy(), np.inf),
                   np.where(j_pres, j_min, np.inf), s)
    assert_d_close(np.where(j_pres, t_max.numpy(), np.inf),
                   np.where(j_pres, j_max, np.inf), s)
    ids = torch.tensor([0, 5, n_s - 1])
    np.testing.assert_array_equal(tidx.rows_for_ids(ids).numpy(),
                                  jidx.rows_for_ids(ids.numpy()))


def test_sindex_from_arrays_carries_the_jax_index():
    s = rt.forest_like(900, 10, seed=8)
    cfg = JConfig(k=5, n_pivots=12)
    jidx = j_build_index(s, cfg)
    tidx = rt.sindex_from_arrays(_index_arrays(jidx),
                                 rt.JoinConfig(k=5, n_pivots=12),
                                 device="cpu")
    for name, arr in _index_arrays(jidx).items():
        obj = tidx.t_s if name.startswith("t_s.") else tidx
        got = getattr(obj, name.split(".")[-1]).numpy()
        np.testing.assert_array_equal(got, arr.astype(got.dtype))
    assert (tidx.n_s, tidx.dim, tidx.n_pivots) == (900, 10, 12)
    with pytest.raises(KeyError, match="missing"):
        rt.sindex_from_arrays({"pivots": jidx.pivots},
                              rt.JoinConfig(k=5), device="cpu")
