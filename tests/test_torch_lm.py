"""The port's LM substrate (``repro_torch.models``, ``serve.serve_step``)
against the JAX package's, on the reduced forms of the four dense configs
and of the two MoE configs (deepseek-v2-lite-16b: MLA, MoE with shared
experts, a dense first layer; arctic-480b: GQA, MoE beside a dense
residual).

The JAX parameters (float32, seeded) are carried across with
``models.params_from_jax``; the same numpy tokens go through both
packages' ``forward`` in train mode, in prefill and in three decode
steps, and through ``BatchedServer.generate``. The port's attention is
K-F's plain version on the CPU.

Tolerance: logits within 2e-5 abs + 2e-5 relative in float32 — the
packages sum the matrix products and the attention's dot products and
softmax in different orders (XLA's dot vs torch's matmul, a full softmax
vs the online one over 128-key tiles); on these reduced models the
logits are O(1) and agree to ~1e-6. Greedy tokens are compared exactly
(no near-tie among the top two logits occurs at these seeds)."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.models import ModelOptions as JOptions  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.serve import BatchedServer as JServer  # noqa: E402
from repro.serve import Datastore as JDatastore  # noqa: E402
from repro.serve import KnnLMConfig as JKnnLMConfig  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.serve_step import (  # noqa: E402
    make_knn_hook as jmake_knn_hook)
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import (  # noqa: E402
    ModelOptions, count_params, forward, init_cache, init_params,
    params_from_jax)
from repro_torch.serve import (  # noqa: E402
    BatchedServer, Datastore, KnnLMConfig, ServeConfig, make_knn_hook)

DENSE = ("llama3.2-3b", "qwen3-14b", "granite-34b", "nemotron-4-15b")
MOE = ("deepseek-v2-lite-16b", "arctic-480b")
ATOL = RTOL = 2e-5


def _pair(arch, seed=0):
    """(JAX config, params), (port config, params): the same weights."""
    jcfg = jget_reduced(arch)
    jopts = JOptions(dtype=jnp.float32, remat=False)
    jp = jinit_params(jcfg, jax.random.PRNGKey(seed), jopts)
    cfg = configs.get_reduced(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    return (jcfg, jp, jopts), (cfg, params_from_jax(np_params, cfg,
                                                    device="cpu"))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_registry_matches_jax():
    from repro.configs import ARCH_IDS, get_arch
    assert configs.ARCH_IDS == ARCH_IDS
    for arch in ARCH_IDS:
        assert dataclasses.asdict(configs.get_arch(arch)) == \
            dataclasses.asdict(get_arch(arch))
        assert dataclasses.asdict(configs.get_reduced(arch)) == \
            dataclasses.asdict(jget_reduced(arch))
        assert configs.get_arch(arch).layout() == get_arch(arch).layout()


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_forward_matches_jax(arch):
    """Train mode over a whole sequence, then prefill into a cache and
    three decode steps against it: logits within the stated tolerance;
    the parameter count equal."""
    (jcfg, jp, jopts), (cfg, params) = _pair(arch)
    assert count_params(params) == sum(
        x.size for x in jax.tree_util.tree_leaves(jp))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 11)).astype(np.int32)
    ops.reset_launch_counts()
    got, _ = forward(params, cfg, torch.from_numpy(toks), mode="train",
                     opts=ModelOptions(dtype=torch.float32))
    want, _ = jforward(jp, jcfg, jnp.asarray(toks), opts=jopts, mode="train")
    _close(got, want)
    assert set(ops.launch_counts().values()) == {0}

    opts = ModelOptions(dtype=torch.float32)
    cache = init_cache(cfg, 2, 16, opts, device="cpu")
    jcache = jinit_cache(jcfg, 2, 16, jopts)
    got, cache = forward(params, cfg, torch.from_numpy(toks[:, :8]),
                         cache=cache, opts=opts, mode="prefill")
    want, jcache = jforward(jp, jcfg, jnp.asarray(toks[:, :8]), cache=jcache,
                            opts=jopts, mode="prefill")
    _close(got, want)
    for t in range(8, 11):
        got, cache = forward(params, cfg, torch.from_numpy(toks[:, t:t + 1]),
                             cache=cache, opts=opts, mode="decode")
        want, jcache = jforward(jp, jcfg, jnp.asarray(toks[:, t:t + 1]),
                                cache=jcache, opts=jopts, mode="decode")
        _close(got, want)
    assert cache["pos"] == 11


def _prompts(vocab):
    rng = np.random.default_rng(2)
    return [rng.integers(0, vocab, n).astype(np.int32)
            for n in (5, 9, 3, 12, 7)]


def test_batched_server_matches_jax():
    """Reduced llama, 5 ragged prompts, batch 2 (three waves), 6 greedy
    tokens: the same tokens as the JAX server's."""
    (jcfg, jp, jopts), (cfg, params) = _pair("llama3.2-3b")
    prompts = _prompts(cfg.vocab)
    want = JServer(jcfg, JServeConfig(batch=2), jp, jopts).generate(
        prompts, max_new_tokens=6)
    got = BatchedServer(cfg, ServeConfig(batch=2), params,
                        ModelOptions(dtype=torch.float32)).generate(
        prompts, max_new_tokens=6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_batched_server_with_knn_hook_matches_jax():
    """The same, with ``make_knn_hook`` over a ``Datastore`` built by each
    package from the same 32-wide keys: the interpolated distributions
    pick the same tokens."""
    (jcfg, jp, jopts), (cfg, params) = _pair("llama3.2-3b")
    rng = np.random.default_rng(3)
    keys = (rng.normal(size=(600, 32)) * 0.05).astype(np.float32)
    vals = rng.integers(0, cfg.vocab, 600).astype(np.int32)
    kw = dict(k=8, n_pivots=32, n_groups=4)
    jstore = JDatastore.build(keys, vals, **kw)
    store = Datastore.build(keys, vals, device="cpu", **kw)
    kcfg = dict(lam=0.5, tau=0.01, k=8)
    prompts = _prompts(cfg.vocab)
    want = JServer(jcfg, JServeConfig(batch=2), jp, jopts,
                   logits_hook=jmake_knn_hook(jstore, JKnnLMConfig(**kcfg),
                                              jcfg.vocab)).generate(
        prompts, max_new_tokens=6)
    ops.reset_launch_counts()
    got = BatchedServer(cfg, ServeConfig(batch=2), params,
                        ModelOptions(dtype=torch.float32),
                        logits_hook=make_knn_hook(store, KnnLMConfig(**kcfg),
                                                  cfg.vocab)).generate(
        prompts, max_new_tokens=6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert set(ops.launch_counts().values()) == {0}


def test_init_params_shapes_and_unported_families():
    """``init_params`` draws the JAX package's shapes from a generator,
    for every family; a logit softcap (not ported) raises, naming its
    item."""
    (jcfg, jp, _), (cfg, _) = _pair("qwen3-14b")
    got = init_params(cfg, torch.Generator().manual_seed(0),
                      ModelOptions(dtype=torch.float32), device="cpu")
    ported = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                             device="cpu")
    flat = jax.tree_util.tree_leaves
    assert [tuple(t.shape) for t in flat(got)] == \
        [tuple(t.shape) for t in flat(ported)]
    for arch in MOE:              # MoE and MLA leaves (a list included)
        (_, jp, _), (cfg, ported) = _pair(arch)
        got = init_params(cfg, torch.Generator().manual_seed(0),
                          ModelOptions(dtype=torch.float32), device="cpu")
        assert [tuple(t.shape) for t in flat(got)] == \
            [tuple(t.shape) for t in flat(ported)]
        assert count_params(got) == sum(x.size for x in flat(jp))
        cache = init_cache(cfg, 2, 16, device="cpu")
        assert len(cache["layers"]) == cfg.n_layers
    for arch in ("xlstm-350m", "whisper-small", "qwen2-vl-7b",
                 "recurrentgemma-9b"):      # the other families (A6b, A6c)
        (_, jp, _), (cfg, ported) = _pair(arch)
        got = init_params(cfg, torch.Generator().manual_seed(0),
                          ModelOptions(dtype=torch.float32), device="cpu")
        assert [tuple(t.shape) for t in flat(got)] == \
            [tuple(t.shape) for t in flat(ported)]
        assert count_params(got) == sum(x.size for x in flat(jp))
    soft = dataclasses.replace(cfg, attn_logit_softcap=30.0)
    with pytest.raises(NotImplementedError, match="softcap"):
        init_params(soft, torch.Generator(), device="cpu")


def test_repeat_kv_sample_and_launcher():
    """``repeat_kv`` as the JAX package's; ``sample`` greedy is the
    argmax and at temperature > 0 a seeded draw inside the vocab; the
    launcher serves the reduced config on the CPU with retrieval."""
    from repro.models.layers import repeat_kv as jrepeat_kv
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.layers import repeat_kv
    from repro_torch.serve import sample
    x = np.random.default_rng(4).normal(size=(2, 5, 3, 4)).astype(np.float32)
    np.testing.assert_array_equal(repeat_kv(torch.from_numpy(x), 3).numpy(),
                                  np.asarray(jrepeat_kv(jnp.asarray(x), 3)))
    logits = torch.from_numpy(
        np.random.default_rng(5).normal(size=(4, 50)).astype(np.float32))
    assert torch.equal(sample(logits, 0.0), torch.argmax(logits, -1).int())
    draws = [sample(logits, 0.7, torch.Generator().manual_seed(9))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1]) and draws[0].dtype == torch.int32
    assert bool(((draws[0] >= 0) & (draws[0] < 50)).all())
    outs = launch_serve.main(["--arch", "llama3.2-3b", "--reduced",
                              "--device", "cpu", "--retrieval",
                              "--requests", "3", "--new-tokens", "2"])
    assert [o.shape for o in outs] == [(2,)] * 3
