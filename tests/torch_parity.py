"""Helpers shared by the port's parity tests (``tests/test_torch_*.py``):
carrying a JAX-built index across, the port's LM weights into the JAX
package's layout (``params_to_jax``), counting float32 ulps, and plain
models of how the CUDA kernels cut their work (K-F's split-KV and
three-term p, K-G's split schedule)."""
import numpy as np

# XLA contracts the JAX chains' multiply-adds into FMAs; the port's
# eager chains round each op — 1–3 ulp apart (ROADMAP Queue C1)
ULP_BOUND = 4


def params_to_jax(params, cfg):
    """The JAX package's parameter tree (numpy float32 leaves) of the
    port's ``params``: the inverse of ``params_from_jax``, each scanned
    group of ``cfg.layout()`` stacking its layers' leaves along a leading
    axis under ``f"l{j}_{kind}"``. The port's ``init_params`` builds a
    model in a fraction of a second where the JAX one, run eagerly,
    compiles each random draw (~12 s for the reduced deepseek), so a test
    can build its weights in the port and give the JAX package the same
    ones."""
    import torch
    from repro_torch.configs.base import ATTN_BIDIR

    def leaf(x):
        return x.detach().to(torch.float32).numpy()

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [conv(v) for v in tree]
        return leaf(tree)

    def stack(layers):
        first = layers[0]
        if isinstance(first, dict):
            return {k: stack([x[k] for x in layers]) for k in first}
        if isinstance(first, (list, tuple)):
            return [stack([x[i] for x in layers]) for i in range(len(first))]
        return np.stack([leaf(x) for x in layers])

    out = {k: conv(v) for k, v in params.items()
           if k not in ("layers", "encoder")}
    groups, start = [], 0
    for unit, reps in cfg.layout():
        groups.append({f"l{j}_{kind}": stack(
            [params["layers"][start + r * len(unit) + j] for r in range(reps)])
            for j, kind in enumerate(unit)})
        start += reps * len(unit)
    out["groups"] = groups
    if "encoder" in params:
        out["encoder"] = {f"l0_{ATTN_BIDIR}": stack(params["encoder"])}
    return out


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


# ---- models of the kernels' cuts (K-F's split-KV and three-term p, K-G's
# split schedule), built on the port's plain versions


def flash_split_kv(q, k, v, split_keys, *, causal=True, window=None,
                   bk=128):
    """K-F's split-KV in plain torch: each range of ``split_keys`` keys
    keeps its own float32 online-softmax state (m, l, acc) over tiles of
    ``bk``; the combine rescales each by exp(m_i − m), sums and divides
    once. Returns (output in q's dtype, m (splits, b, nq, h))."""
    import torch
    b, nq, h, d = q.shape
    nk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    qf = q.to(torch.float32).permute(0, 2, 1, 3)
    kf = k.to(torch.float32).permute(0, 2, 1, 3).repeat_interleave(rep, 1)
    vf = v.to(torch.float32).permute(0, 2, 1, 3).repeat_interleave(rep, 1)
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    q_pos = torch.arange(nq)[:, None] + (nk - nq)
    ms, ls, accs = [], [], []
    for lo in range(0, max(nk, 1), split_keys):
        hi = min(nk, lo + split_keys)
        m = torch.full((b, h, nq), -1e30)
        l = torch.zeros((b, h, nq))
        acc = torch.zeros((b, h, nq, d))
        for j0 in range(lo, hi, bk):
            j1 = min(hi, j0 + bk)
            k_pos = torch.arange(j0, j1)[None, :]
            mask = torch.ones((nq, j1 - j0), dtype=torch.bool)
            if causal:
                mask &= k_pos <= q_pos
            if window is not None:
                mask &= k_pos > q_pos - window
            s = torch.where(mask, (qf @ kf[:, :, j0:j1].transpose(-1, -2))
                            * scale, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ vf[:, :, j0:j1]
            m = m_new
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    w = torch.exp(m - m.amax(0))
    out = ((acc * w[..., None]).sum(0)
           / torch.clamp((l * w).sum(0), min=1e-30)[..., None])
    return out.permute(0, 2, 1, 3).to(q.dtype), m.permute(0, 1, 3, 2)


def split_p3(p):
    """K-F's tensor-core form's split of float32 p ≥ 0, after the exact
    scaling by 2³²: hi = bf16(p), mid = bf16(p − hi), lo = bf16(p − hi −
    mid), each subtraction in float32, each rounding to nearest even."""
    import torch
    ps = p.to(torch.float32) * 2.0 ** 32
    hi = ps.to(torch.bfloat16)
    r1 = ps - hi.to(torch.float32)
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def gather_split_plain(r, s, k, schedule, counts, plan, *, alive=None,
                       bm=128, bn=512):
    """K-G's split schedule in plain torch: the plain version's run over
    each visit range of ``plan`` (slots [i·per, (i+1)·per)), then the
    ranges' runs merged in (d², position) order (an empty slot's −1 last)
    and the first k written as (√d² float32, int32 positions)."""
    import torch
    from repro_torch.kernels import distance_topk as kg
    n_r = r.shape[0]
    cand_d, cand_p = [], []
    for i in range(plan.splits):
        lo = i * plan.per
        hi = min(schedule.shape[1], lo + plan.per)
        sub = torch.clamp(counts.to(torch.int64) - lo, 0, max(hi - lo, 0))
        run_d, run_p = kg._gather_runs_plain(r, s, k, schedule[:, lo:hi],
                                             sub, alive, bm, bn)
        cand_d.append(run_d.reshape(-1, run_d.shape[-1])[:n_r])
        cand_p.append(run_p.reshape(-1, run_p.shape[-1])[:n_r])
    cand_d, cand_p = torch.cat(cand_d, 1), torch.cat(cand_p, 1)
    by_p = torch.argsort(torch.where(cand_p < 0, torch.iinfo(torch.int64).max,
                                     cand_p), dim=1, stable=True)
    cand_d = torch.take_along_dim(cand_d, by_p, 1)
    cand_p = torch.take_along_dim(cand_p, by_p, 1)
    cand_d, order = torch.sort(cand_d, dim=1, stable=True)
    run_d = cand_d[:, :k]
    run_p = torch.take_along_dim(cand_p, order[:, :k], 1)
    return (torch.sqrt(run_d),
            torch.where(torch.isfinite(run_d), run_p, -1).to(torch.int32))


def _merge_runs(cand_d, cand_p, width):
    """Concatenated runs (value, int64 position; -1 empty) merged in
    (value, position) order, the empty slot's -1 last: the first
    ``width`` of each row."""
    import torch
    by_p = torch.argsort(torch.where(cand_p < 0, torch.iinfo(torch.int64).max,
                                     cand_p), dim=1, stable=True)
    cand_d = torch.take_along_dim(cand_d, by_p, 1)
    cand_p = torch.take_along_dim(cand_p, by_p, 1)
    cand_d, order = torch.sort(cand_d, dim=1, stable=True)
    return cand_d[:, :width], torch.take_along_dim(cand_p, order[:, :width],
                                                   1)


def dense_split_plain(r, s, k, plan, *, visit_mask=None, bm=128, bn=512):
    """K-D's split in plain torch: the plain version's run over each range
    of ``plan.per`` S tiles (the visit mask cut to it), then the ranges'
    runs merged in (d², id) order and the first k written as (√d²
    float32, int32 ids)."""
    import torch
    from repro_torch.kernels import distance_topk as kd
    nr_tiles, ns_tiles = -(-r.shape[0] // bm), -(-s.shape[0] // bn)
    base = (torch.ones((nr_tiles, ns_tiles), dtype=torch.int8)
            if visit_mask is None else visit_mask)
    cand_d, cand_p = [], []
    for i in range(plan.splits):
        cut = torch.zeros_like(base)
        cut[:, i * plan.per:(i + 1) * plan.per] = 1
        run_d, run_p = kd._dense_runs_plain(r, s, k, base * cut, bm, bn)
        cand_d.append(run_d)
        cand_p.append(run_p)
    run_d, run_p = _merge_runs(torch.cat(cand_d, 1), torch.cat(cand_p, 1), k)
    return (torch.sqrt(run_d.to(torch.float64)).to(torch.float32),
            torch.where(torch.isfinite(run_d), run_p, -1).to(torch.int32))


def quant_split_plain(args, mp, schedule, counts, plan, *, bm=128, bn=512):
    """K-Q's split schedule in plain torch: the plain schedule walk over
    each visit range of ``plan`` (slots [i·per, (i+1)·per)), then the
    ranges' runs merged in (lb, position) order and positions of
    non-finite lb written as -1."""
    import torch
    from repro_torch.kernels import quant_topk as kq
    cand_d, cand_p = [], []
    for i in range(plan.splits):
        lo = i * plan.per
        hi = min(schedule.shape[1], lo + plan.per)
        sub = torch.clamp(counts.to(torch.int64) - lo, 0, max(hi - lo, 0))
        lb, pos = kq.quant_coarse_sched_plain(*args, mp, schedule[:, lo:hi],
                                              sub.to(torch.int32), bm=bm,
                                              bn=bn)
        cand_d.append(lb)
        cand_p.append(pos.to(torch.int64))
    lb, pos = _merge_runs(torch.cat(cand_d, 1), torch.cat(cand_p, 1), mp)
    return lb, torch.where(torch.isfinite(lb), pos, -1).to(torch.int32)


def assign_split_plain(x, pivots, groups):
    """K-A's cut in plain torch: d² by the plain version's arithmetic (one
    row block), each group of pivot ids (a split's range, or the pivots one
    thread of a tile sees) reduced to its first minimum, and the groups'
    minima folded as the kernel folds them — as the 64-bit keys (d² bits
    << 32) | id under a minimum. Returns (int32 ids, float32 √d²)."""
    import torch
    p = pivots.to(torch.float32)
    d2 = torch.clamp((x * x).sum(-1, keepdim=True)
                     + (p * p).sum(-1, keepdim=True).T - 2.0 * (x @ p.T),
                     min=0.0)
    keys = []
    for ids in groups:
        ids = torch.as_tensor(ids, dtype=torch.int64)
        sub = d2[:, ids]
        at = torch.argmin(sub, dim=1)
        best = torch.gather(sub, 1, at[:, None])[:, 0]
        keys.append((best.view(torch.int32).to(torch.int64) << 32) | ids[at])
    key = torch.stack(keys).amin(0)
    best = (key >> 32).to(torch.int32).view(torch.float32)
    return ((key & 0xFFFFFFFF).to(torch.int32),
            torch.sqrt(best[:, None])[:, 0])
