"""kNN-LM retrieval in the port (``repro_torch.serve.retrieval``) against
the JAX package's ``serve.retrieval``: the tests of
``tests/test_serve.py`` but the batched server's (the LM substrate is
ROADMAP Queue A6), on the CPU plain versions.

Tolerances, stated per test: both packages' join routes report the
canonical distances (within 4 ulp of each other, ROADMAP Queue C1), so
their log-probabilities agree within 2e-5 (a d² moved by 8 ulp moves
each softmax logit −d²/τ by under 1e-5 at these scales, and a
log-probability by at most twice that); the kernel route's √d² comes
from the expanded form, so it is held to the join route as the JAX
package holds its two routes (2e-4)."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.core import brute_force_knn as jbrute  # noqa: E402
from repro_torch import serve  # noqa: E402
from repro_torch.core import index as index_mod  # noqa: E402
from repro_torch.serve import Datastore, KnnLMConfig, knn_logits  # noqa: E402

LP_ATOL = 2e-5          # join route vs the JAX package's join route
ROUTES_TOL = 2e-4       # kernel route vs join route (as the JAX test)


def _store(keys, vals, **kw):
    return Datastore.build(keys, vals, device="cpu", **kw)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_knn_logits_match_jax_and_bruteforce(use_kernel):
    rng = np.random.default_rng(1)
    keys = rng.normal(size=(500, 16)).astype(np.float32)
    vals = rng.integers(0, 64, 500).astype(np.int32)
    store = _store(keys, vals, k=4, n_pivots=32, n_groups=4)
    jstore = jserve.Datastore.build(keys, vals, k=4, n_pivots=32,
                                    n_groups=4)
    q = rng.normal(size=(6, 16)).astype(np.float32)
    kcfg = KnnLMConfig(k=4)
    lg, (d, ids) = knn_logits(q, store, kcfg, vocab=64,
                              use_kernel=use_kernel, return_neighbors=True)
    assert lg.shape == (6, 64) and lg.dtype == np.float32
    jlg = jserve.knn_logits(q, jstore, jserve.KnnLMConfig(k=4), vocab=64,
                            use_kernel=use_kernel)
    np.testing.assert_allclose(lg, jlg, atol=ROUTES_TOL if use_kernel
                               else LP_ATOL, rtol=0)
    bd, bi = jbrute(q, keys, 4)
    np.testing.assert_array_equal(ids, bi)
    np.testing.assert_allclose(d, bd, rtol=1e-5)
    for i in range(6):
        # the mass sits on the true neighbours' tokens
        top_tokens = set(vals[bi[i]].tolist())
        got = set(np.argsort(lg[i])[::-1][:len(top_tokens)].tolist())
        assert got & top_tokens


@pytest.mark.parametrize("quantized", [False, True])
def test_knn_logits_join_and_kernel_paths_agree(quantized):
    """The join route (megastep, or the int8 tier) and the K-D route give
    the same retrieval distribution."""
    rng = np.random.default_rng(2)
    keys = rng.normal(size=(400, 12)).astype(np.float32)
    vals = rng.integers(0, 48, 400).astype(np.int32)
    store = _store(keys, vals, k=6, n_pivots=32, n_groups=4,
                   quantized=quantized)
    q = rng.normal(size=(5, 12)).astype(np.float32)
    kcfg = KnnLMConfig(k=6, tau=10.0)
    lg_join = knn_logits(q, store, kcfg, vocab=48, use_kernel=False)
    lg_kern = knn_logits(q, store, kcfg, vocab=48, use_kernel=True)
    np.testing.assert_allclose(lg_join, lg_kern, rtol=ROUTES_TOL,
                               atol=ROUTES_TOL)
    if quantized:
        plain = _store(keys, vals, k=6, n_pivots=32, n_groups=4)
        np.testing.assert_array_equal(
            lg_join, knn_logits(q, plain, kcfg, vocab=48))


def _guard_phase1(monkeypatch, sizes=None):
    orig = index_mod.assign_and_summarize

    def guard(data, *a, **kw):
        if sizes is None:
            raise AssertionError("S-side phase 1 re-ran during serving")
        sizes.append(data.shape[0])
        return orig(data, *a, **kw)

    monkeypatch.setattr(index_mod, "assign_and_summarize", guard)


def test_datastore_index_reused_across_decode_steps(monkeypatch):
    """Serving never re-runs S-side phase 1: decode batches reuse the
    resident index through both routes."""
    rng = np.random.default_rng(3)
    keys = rng.normal(size=(300, 8)).astype(np.float32)
    vals = rng.integers(0, 32, 300).astype(np.int32)
    store = _store(keys, vals, k=4, n_pivots=16, n_groups=2)
    kcfg = KnnLMConfig(k=4)
    _guard_phase1(monkeypatch)
    for seed in (4, 5):
        q = np.random.default_rng(seed).normal(size=(3, 8)).astype(
            np.float32)
        for use_kernel in (False, True):
            lg = knn_logits(q, store, kcfg, vocab=32, use_kernel=use_kernel)
            assert lg.shape == (3, 32)


def test_add_entries_mid_decode_no_phase1_on_existing_segments(monkeypatch):
    """``add_entries`` mid-decode changes retrieval without re-running
    phase 1 on existing segments (the only run is over the delta's 3
    rows); ``remove_entries`` restores the first distribution."""
    rng = np.random.default_rng(11)
    keys = rng.normal(size=(300, 8)).astype(np.float32)
    vals = rng.integers(0, 32, 300).astype(np.int32)
    store = _store(keys, vals, k=4, n_pivots=16, n_groups=2,
                   seal_threshold=2)
    kcfg = KnnLMConfig(k=4, tau=5.0)
    q = rng.normal(size=(3, 8)).astype(np.float32)
    before = knn_logits(q, store, kcfg, vocab=40)
    sizes = []
    _guard_phase1(monkeypatch, sizes)
    ids = store.add_entries(q, np.full(3, 39, np.int32))
    assert store.index.n_segments == 2 and store.index.n_buffered == 0
    after = knn_logits(q, store, kcfg, vocab=40)
    after_k = knn_logits(q, store, kcfg, vocab=40, use_kernel=True)
    assert sizes == [3]
    assert not np.array_equal(before, after)
    assert (after.argmax(1) == 39).all() and (after_k.argmax(1) == 39).all()
    store.remove_entries(ids)
    np.testing.assert_allclose(knn_logits(q, store, kcfg, vocab=40), before,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_knn_logits_masks_padding_and_missing_neighbors(use_kernel):
    """Fewer live entries than k: padded slots get no mass (no
    ``values[-1]`` wraparound), no NaN; no live entry: the log floor."""
    rng = np.random.default_rng(12)
    keys = rng.normal(size=(40, 6)).astype(np.float32)
    vals = rng.integers(0, 8, 40).astype(np.int32)
    vals[-1] = 9                                  # the wraparound target
    store = _store(keys, vals, k=4, n_pivots=8, n_groups=2)
    q = rng.normal(size=(5, 6)).astype(np.float32)
    store.remove_entries(np.arange(3, 40))
    assert store.n_entries == 3
    lg = knn_logits(q, store, KnnLMConfig(k=4), vocab=10,
                    use_kernel=use_kernel)
    assert np.isfinite(lg).all()
    live_tokens = set(vals[:3].tolist())
    for t in range(10):
        if t not in live_tokens:
            np.testing.assert_allclose(lg[:, t], np.log(1e-9))
    store.remove_entries(np.arange(3))
    lg = knn_logits(q, store, KnnLMConfig(k=4), vocab=10,
                    use_kernel=use_kernel)
    np.testing.assert_allclose(lg, np.log(1e-9))


def test_datastore_compact_remaps_values_like_jax():
    """Compaction re-bases ids and remaps the value table, so retrieval
    is unchanged; the same mutations on the JAX package's store give the
    same distribution."""
    rng = np.random.default_rng(13)
    keys = rng.normal(size=(200, 8)).astype(np.float32)
    vals = rng.integers(0, 32, 200).astype(np.int32)
    new_k = rng.normal(size=(10, 8)).astype(np.float32)
    new_v = rng.integers(0, 32, 10).astype(np.int32)
    q = rng.normal(size=(4, 8)).astype(np.float32)
    kcfg = KnnLMConfig(k=4, tau=5.0)
    store = _store(keys, vals, k=4, n_pivots=16, n_groups=2,
                   seal_threshold=8)
    jstore = jserve.Datastore.build(keys, vals, k=4, n_pivots=16,
                                    n_groups=2, seal_threshold=8)
    for st in (store, jstore):
        st.add_entries(new_k, new_v)
        st.remove_entries([0, 5, 203])
    before = knn_logits(q, store, kcfg, vocab=32)
    jkcfg = jserve.KnnLMConfig(k=4, tau=5.0)
    np.testing.assert_allclose(before, jserve.knn_logits(q, jstore, jkcfg,
                                                         vocab=32),
                               atol=LP_ATOL, rtol=0)
    np.testing.assert_array_equal(store.compact(), jstore.compact())
    assert store.index.n_segments == 1 and store.keys.shape[0] == 207
    np.testing.assert_array_equal(store.keys, jstore.keys)
    np.testing.assert_array_equal(store.values, jstore.values)
    for use_kernel in (False, True):
        after = knn_logits(q, store, kcfg, vocab=32, use_kernel=use_kernel)
        np.testing.assert_allclose(after, before, rtol=ROUTES_TOL,
                                   atol=ROUTES_TOL)


def test_interpolation_limits_match_jax():
    lm = np.log(np.asarray([[0.7, 0.2, 0.1]], np.float32))
    knn = np.log(np.asarray([[0.05, 0.05, 0.9]], np.float32))
    for lam, want in ((0.0, [0.7, 0.2, 0.1]), (1.0, [0.05, 0.05, 0.9]),
                      (0.3, None)):
        got = serve.interpolate(torch.from_numpy(lm), knn, lam)
        assert isinstance(got, torch.Tensor)
        p = np.exp(got.numpy())
        ref = np.asarray(jserve.interpolate(jnp.asarray(lm), knn, lam))
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
        if want is not None:
            np.testing.assert_allclose(p[0] / p[0].sum(), want, atol=1e-3)


def test_bf16_ingestion_add_seal_query():
    """bfloat16 hidden states are cast to float32 once at the store's
    boundary — bf16 ⊂ f32, so a bf16-fed store is bitwise the f32-fed
    one through add → seal → query — and non-float dtypes raise."""
    rng = np.random.default_rng(3)
    base = rng.normal(size=(300, 12)).astype(np.float32)
    vals = rng.integers(0, 40, 300).astype(np.int32)
    new = rng.normal(size=(180, 12)).astype(np.float32)
    nv = rng.integers(0, 40, 180).astype(np.int32)
    base_bf = torch.from_numpy(base).to(torch.bfloat16)
    new_bf = torch.from_numpy(new).to(torch.bfloat16)
    st_bf = _store(base_bf, vals, k=5, n_pivots=24, seal_threshold=120)
    st_f = _store(base_bf.float().numpy(), vals, k=5, n_pivots=24,
                  seal_threshold=120)
    assert st_bf.keys.dtype == np.float32
    np.testing.assert_array_equal(st_bf.add_entries(new_bf, nv),
                                  st_f.add_entries(new_bf.float().numpy(),
                                                   nv))
    assert st_bf.index.n_segments >= 2               # a delta sealed
    q = rng.normal(size=(6, 12)).astype(np.float32)
    kcfg = KnnLMConfig(k=5, tau=8.0)
    for use_kernel in (False, True):
        np.testing.assert_array_equal(
            knn_logits(q, st_bf, kcfg, 40, use_kernel=use_kernel),
            knn_logits(q, st_f, kcfg, 40, use_kernel=use_kernel))
    with pytest.raises(TypeError):
        _store(base.astype(np.int32), vals, k=5, n_pivots=24)
    with pytest.raises(TypeError):
        st_bf.add_entries(np.ones((2, 12), np.int64), np.zeros(2, np.int32))


def test_retrieve_never_serves_torn_index_across_mutation():
    """A writer adds entries and compacts while readers call
    ``retrieve``: every result matches the brute force of one index
    version that existed — never a mix of two."""
    rng = np.random.default_rng(11)
    dim, k = 8, 4
    base = rng.normal(size=(400, dim)).astype(np.float32)
    vals = rng.integers(0, 50, 400).astype(np.int32)
    store = _store(base, vals, k=k, n_pivots=16, seal_threshold=100)
    q = rng.normal(size=(5, dim)).astype(np.float32)
    oracles = {}

    def snapshot_oracle():
        with store._lock:
            v = store.index.version
            if v in oracles:
                return
            keys, ids = store.index.live_rows()
        d = np.linalg.norm(q[:, None, :] - keys[None, :, :], axis=-1)
        order = np.argsort(d, axis=1, kind="stable")[:, :k]
        oracles[v] = (np.take_along_axis(d, order, axis=1).astype(
            np.float32), ids[order])

    snapshot_oracle()
    store.retrieve(q, k)
    stop = threading.Event()
    errors, results = [], []

    def writer():
        try:
            r = np.random.default_rng(7)
            for i in range(8):
                store.add_entries(r.normal(size=(30, dim)).astype(
                    np.float32), r.integers(0, 50, 30).astype(np.int32))
                snapshot_oracle()
                if i == 4:
                    store.compact()
                    snapshot_oracle()
                # pace on reader progress, not wall time
                goal = len(results) + 2
                t0 = time.monotonic()
                while len(results) < goal and time.monotonic() - t0 < 10:
                    time.sleep(0.005)
        except Exception as e:          # surfaced below
            errors.append(e)
        finally:
            stop.set()

    def reader():
        try:
            while not stop.is_set():
                d, idx, _ = store.retrieve(q, k)
                results.append((np.asarray(d), np.asarray(idx)))
        except Exception as e:          # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=writer)] + [
        threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    assert len(results) > 10 and len(oracles) >= 3
    for d, idx in results:
        assert any(d.shape == od.shape and np.allclose(d, od, atol=1e-4)
                   for od, _ in oracles.values()), \
            "result matches no single index version (torn read)"
