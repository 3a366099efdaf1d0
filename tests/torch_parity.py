"""Helpers shared by the port's parity tests (``tests/test_torch_*.py``):
carrying a JAX-built index across and counting float32 ulps."""
import numpy as np

# XLA contracts the JAX chains' multiply-adds into FMAs; the port's
# eager chains round each op — 1–3 ulp apart (ROADMAP Queue C1)
ULP_BOUND = 4


def ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def index_arrays(jidx, *, quant_bn=None):
    """The numpy fields of a JAX ``SIndex`` for ``sindex_from_arrays``
    (with its int8 twin at tile size ``quant_bn`` when given)."""
    out = {"pivots": jidx.pivots, "pivd": jidx.pivd, "s_part": jidx.s_part,
           "s_dist": jidx.s_dist, "t_s.counts": jidx.t_s.counts,
           "t_s.lower": jidx.t_s.lower, "t_s.upper": jidx.t_s.upper,
           "t_s.knn_dists": jidx.t_s.knn_dists, "s_order": jidx.s_order,
           "s_sorted": jidx.s_sorted, "s_part_sorted": jidx.s_part_sorted,
           "s_dist_sorted": jidx.s_dist_sorted,
           "s_ids_sorted": jidx.s_ids_sorted, "s_inv": jidx.s_inv}
    if quant_bn is not None:
        qr = jidx.ensure_quant(quant_bn)
        out.update({"quant.q": qr.q, "quant.scales": qr.scales,
                    "quant.eps": qr.eps})
    return out


def data(kind, n_s=2500, n_r=300, dim=8, seed=0):
    """(S, R): Gaussian rows, or Forest-like rows (values to ~1000)."""
    if kind == "forest":
        import repro_torch as rt
        return (rt.forest_like(n_s, 10, seed=seed),
                rt.forest_like(n_r, 10, seed=seed + 1))
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_s, dim)).astype(np.float32),
            rng.normal(size=(n_r, dim)).astype(np.float32))


def assert_same_join(got_d, got_i, ref_d, ref_i, *, exact_ids=False):
    """Distances within ULP_BOUND; ids equal except among tied
    distances (or everywhere with ``exact_ids``)."""
    assert ulps(got_d, ref_d).max() <= ULP_BOUND
    mism = got_i != ref_i
    assert (ulps(got_d[mism], ref_d[mism]) <= ULP_BOUND).all()
    if exact_ids:
        assert not mism.any()


def assert_d_close(got, want, rows):
    """Assignment distances of the two packages: they sum d² =
    ‖x‖²+‖p‖²−2x·p in different orders, so d² agree within 2⁻¹⁸ (32
    fp32 ulps) of the largest ‖x‖²+‖p‖² (``rows`` holds both sides)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all()
    atol = 2.0 ** -18 * 2 * float((np.asarray(rows, np.float64) ** 2)
                                  .sum(1).max())
    np.testing.assert_allclose(got[fin] ** 2, want[fin] ** 2, rtol=1e-5,
                               atol=atol)
