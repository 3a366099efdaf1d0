"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's ``models.moe`` on the reduced MoE configs, and the reduced
deepseek-v2-lite-16b served with the kNN-LM hook.

Routing: the experts chosen, the buffer slots and the kept mask equal
JAX's exactly (the JAX half below repeats ``_moe_tokens``' routing lines
with its own ops: ``jax.lax.top_k``, one-hot cumsum in choice-major
order). Inputs and router weights are multiples of 1/4 and 1/8, so
every bfloat16 router logit is exact in both packages and ties are
many: the tie rule (lower expert first) is what the test pins.

Tolerances: routed outputs in float32 within 2e-5 abs + 2e-5 relative
(the packages sum the k choices and the matrix products in different
orders); gate weights within 1e-6. Adds about 30 s to the suite in one
process (the JAX server's compiles dominate)."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.models.layers import dense as jdense  # noqa: E402
from repro.models.moe import moe_apply as jmoe_apply  # noqa: E402
from repro.models.moe import moe_init as jmoe_init  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ATOL = RTOL = 2e-5
MOE = ("deepseek-v2-lite-16b", "arctic-480b")


def _tree(x, dtype=None):
    """A JAX parameter tree as torch tensors (dicts and lists kept)."""
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(
            dtype or torch.float32), x)


def _jax_route(jp, xf, cfg):
    """``_moe_tokens``' routing (``src/repro/models/moe.py:87-101``)."""
    mo = cfg.moe
    n = xf.shape[0]
    e, k = mo.n_experts, mo.top_k
    cap = max(1, int(k * n * mo.capacity_factor / e))
    logits = jdense(jp["router"], xf).astype(jnp.float32)
    gates = jax.nn.softmax(logits, -1)
    topw, tope = jax.lax.top_k(gates, k)
    topw = topw / jnp.maximum(topw.sum(-1, keepdims=True), 1e-9)
    sel = jax.nn.one_hot(tope, e, dtype=jnp.float32)
    sel_flat = sel.transpose(1, 0, 2).reshape(k * n, e)
    pos_flat = jnp.cumsum(sel_flat, axis=0) - 1.0
    pos = (pos_flat * sel_flat).sum(-1).reshape(k, n).T
    return (np.asarray(tope), np.asarray(pos).astype(np.int64),
            np.asarray(pos < cap), np.asarray(topw), cap)


def _grid(rng, shape, step):
    """Values on a coarse grid, exact in bfloat16 and in their sums."""
    return (rng.integers(-2, 3, shape) * step).astype(np.float32)


def _case(name):
    cfg = configs.get_reduced("deepseek-v2-lite-16b")
    if name == "drops":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=0.5))
    if name in ("chunked", "unchunked"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.0))
    n = {"ties_bf16": 64, "drops": 96, "chunked": 8192,
         "unchunked": 4100}[name]
    return cfg, n


@pytest.mark.parametrize("name", ["ties_bf16", "drops", "chunked",
                                  "unchunked"])
def test_routing_matches_jax(name):
    """Experts, slots and the kept mask exactly; gate weights to 1e-6.
    bfloat16 router logits on a grid (ties everywhere, two experts with
    one router column); a capacity that drops; 8,192 tokens routed per
    4,096-token chunk and 4,100 in one block."""
    cfg, n = _case(name)
    rng = np.random.default_rng(11)
    d, e = cfg.d_model, cfg.moe.n_experts
    w = _grid(rng, (d, e), 0.125)
    w[:, 5] = w[:, 2]                        # two experts always tie
    x = _grid(rng, (n, d), 0.25)
    bf16 = name == "ties_bf16"
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                           torch.float32)
    jp = {"router": {"w": jnp.asarray(w, jdt)}}
    tp = {"router": {"w": torch.from_numpy(w).to(tdt)}}
    blocks = [(lo, min(lo + moe._MOE_CHUNK, n))
              for lo in range(0, n, moe._MOE_CHUNK)] \
        if n % moe._MOE_CHUNK == 0 else [(0, n)]
    dropped = 0
    for lo, hi in blocks:
        want = _jax_route(jp, jnp.asarray(x[lo:hi], jdt), cfg)
        got = moe.moe_route(tp, torch.from_numpy(x[lo:hi]).to(tdt), cfg)
        for g, wnt in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g.numpy(), wnt)
        np.testing.assert_allclose(got[3].numpy(), want[3], atol=1e-6)
        assert got[4] == want[4]
        dropped += int((~got[2]).sum())
    if name == "ties_bf16":              # expert 5 only ever after 2
        has5 = (want[0] == 5).any(1)
        assert (want[0] == 2).any() and has5.any()
        assert ((want[0] == 2).argmax(1) < (want[0] == 5).argmax(1))[
            has5].all()
    assert (dropped > 0) == (name in ("drops", "chunked", "unchunked"))


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("n_tok", [12, 8192])
def test_moe_apply_matches_jax(arch, n_tok):
    """``moe_apply`` in float32 (shared experts, Arctic's dense residual)
    on JAX weights, within the stated tolerance; at 8,192 tokens the
    routing is chunked and the capacity drops tokens."""
    jcfg = jget_reduced(arch)
    cfg = configs.get_reduced(arch)
    if n_tok > moe._MOE_CHUNK:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.0))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=1.0))
    jp = jmoe_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    x = np.random.default_rng(12).normal(
        size=(2, n_tok // 2, cfg.d_model)).astype(np.float32)
    want = np.asarray(jmoe_apply(jp, jnp.asarray(x), jcfg))
    moe.drop_log = []
    try:
        got = moe.moe_apply(_tree(jp), torch.from_numpy(x), cfg).numpy()
        log = moe.drop_log
    finally:
        moe.drop_log = None
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert len(log) == max(1, n_tok // moe._MOE_CHUNK)
    assert (sum(k for k, _ in log) < sum(t for _, t in log)) == \
        (n_tok > moe._MOE_CHUNK)


def test_moe_init_shapes_and_sliced_draw(monkeypatch):
    """``moe_init`` gives the JAX leaves' shapes; a leaf drawn in slices
    (as the full configs' experts are) has its shape, dtype and scale,
    and a seed gives it the same values every time."""
    from repro_torch.models import layers
    jcfg, cfg = jget_reduced("arctic-480b"), configs.get_reduced(
        "arctic-480b")
    jp = jmoe_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32,
                      "cpu")
    assert jax.tree_util.tree_map(np.shape, jp) == \
        jax.tree_util.tree_map(lambda t: tuple(t.shape), tp)
    monkeypatch.setattr(layers, "_DRAW_ELEMS", 1000)
    cut = [layers.normal_init(torch.Generator().manual_seed(5), (64, 50, 4),
                              0.5, torch.bfloat16, "cpu") for _ in range(2)]
    assert cut[0].shape == (64, 50, 4) and cut[0].dtype == torch.bfloat16
    assert torch.equal(cut[0], cut[1])
    assert abs(float(cut[0].float().std()) - 0.5) < 0.02


def test_batched_server_deepseek_with_knn_hook_matches_jax():
    """Reduced deepseek-v2-lite-16b (MLA, MoE, a dense first layer), 2
    ragged prompts in one wave, 4 greedy tokens with ``make_knn_hook``
    over a datastore each package builds from the same keys: the same
    tokens as the JAX server's."""
    from repro.models import ModelOptions as JOptions
    from repro.models import init_params as jinit_params
    from repro.serve import BatchedServer as JServer
    from repro.serve import Datastore as JDatastore
    from repro.serve import KnnLMConfig as JKnnLMConfig
    from repro.serve import ServeConfig as JServeConfig
    from repro.serve.serve_step import make_knn_hook as jmake_knn_hook
    from repro_torch.models import ModelOptions, params_from_jax
    from repro_torch.serve import (BatchedServer, Datastore, KnnLMConfig,
                                   ServeConfig, make_knn_hook)
    jcfg = jget_reduced("deepseek-v2-lite-16b")
    cfg = configs.get_reduced("deepseek-v2-lite-16b")
    jopts = JOptions(dtype=jnp.float32, remat=False)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0), jopts)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                             device="cpu")
    rng = np.random.default_rng(3)
    keys = (rng.normal(size=(600, 32)) * 0.05).astype(np.float32)
    vals = rng.integers(0, cfg.vocab, 600).astype(np.int32)
    kw = dict(k=8, n_pivots=32, n_groups=4)
    kcfg = dict(lam=0.5, tau=0.01, k=8)
    prompts = [np.random.default_rng(2).integers(0, cfg.vocab, n)
               .astype(np.int32) for n in (5, 9)]
    want = JServer(jcfg, JServeConfig(batch=2), jp, jopts,
                   logits_hook=jmake_knn_hook(JDatastore.build(keys, vals,
                                                               **kw),
                                              JKnnLMConfig(**kcfg),
                                              jcfg.vocab)).generate(
        prompts, max_new_tokens=4)
    got = BatchedServer(cfg, ServeConfig(batch=2), params,
                        ModelOptions(dtype=torch.float32),
                        logits_hook=make_knn_hook(
                            Datastore.build(keys, vals, device="cpu", **kw),
                            KnnLMConfig(**kcfg), cfg.vocab)).generate(
        prompts, max_new_tokens=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
