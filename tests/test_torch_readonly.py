"""The read-only serving cache (``ModelOptions(readonly_cache=True)``) on
the CPU, against the JAX package's: a decode step over a prefilled cache
through ``forward(mode="decode")`` for a dense (llama3.2-3b), an MLA
(deepseek-v2-lite-16b) and an audio (whisper-small: the decoder's
self-attention) reduced model — the logits, and every layer's fresh
pieces compared by name (``k_new``, ``v_new``; ``ckv_new``,
``k_rope_new``; whisper's ``self`` beside its projected encoder kv) —
with the input cache left bitwise untouched; then several read-only steps
with the fresh pieces appended out of band (``append_readonly``) against
the written-cache decode on the same tokens. The port's attention is
K-F's plain version, with the fresh keys as its second key source.

Tolerance: logits within 2e-5 abs + 2e-5 rel and fresh pieces within
1e-5 abs + 1e-5 rel in float32 (the packages sum the matrix products and
the softmax in other orders; ``test_torch_lm.py``'s limits). The weights
are the port's ``init_params``, carried into the JAX layout
(``torch_parity.params_to_jax``). The file's tests take ~7 s of the run
(the JAX side's compiles)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.models import ModelOptions as JOptions  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import (ModelOptions, append_readonly,  # noqa: E402
                                forward, init_cache, init_params,
                                layer_kinds)
from repro_torch.tree import leaves  # noqa: E402
from torch_parity import params_to_jax  # noqa: E402

ATOL = RTOL = 2e-5
ARCHS = ("llama3.2-3b", "deepseek-v2-lite-16b", "whisper-small")
B, T, CLEN = 2, 9, 16

_jforward = jax.jit(jforward, static_argnums=(1,),
                    static_argnames=("opts", "mode"))


def _setup(arch, seed=0):
    jcfg = jget_reduced(arch)
    jopts = JOptions(dtype=jnp.float32, remat=False, max_abs_pos=96)
    cfg = configs.get_reduced(arch)
    p = init_params(cfg, torch.Generator().manual_seed(seed),
                    ModelOptions(dtype=torch.float32, remat=False,
                                 max_abs_pos=96), device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, params_to_jax(p, cfg))
    rng = np.random.default_rng(seed + 1)
    tokens = rng.integers(0, cfg.vocab, (B, T + 4)).astype(np.int32)
    extra = {}
    if cfg.n_enc_layers:
        extra["enc_frames"] = rng.standard_normal(
            (B, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return (jcfg, jp, jopts), (cfg, p), tokens, extra


def _jax_fresh(jcfg, groups):
    """The JAX package's fresh pieces, one dict a layer in the port's
    order (its groups stack each kind of a unit along a leading axis)."""
    out, start = {}, 0
    for (unit, reps), g in zip(jcfg.layout(), groups):
        for j, kind in enumerate(unit):
            node = g[f"l{j}_{kind}"]
            for r in range(reps):
                out[start + r * len(unit) + j] = jax.tree_util.tree_map(
                    lambda x: np.asarray(x[r]), node)
        start += reps * len(unit)
    return [out[i] for i in range(len(out))]


def _compare_fresh(got, want, pos, what):
    assert set(got) == set(want), what
    for key in want:
        if key == "pos":
            assert got[key] == pos and int(want[key]) == pos, what
        elif isinstance(want[key], dict):
            _compare_fresh(got[key], want[key], pos, f"{what}/{key}")
        else:
            np.testing.assert_allclose(got[key].numpy(), want[key],
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{what}/{key}")


@pytest.mark.parametrize("arch", ARCHS)
def test_readonly_decode_matches_jax(arch):
    (jcfg, jp, jopts), (cfg, p), tokens, extra = _setup(arch)
    opts = ModelOptions(dtype=torch.float32, remat=False, max_abs_pos=96)
    jx = {k: jnp.asarray(v) for k, v in extra.items()}
    tx = {k: torch.as_tensor(v) for k, v in extra.items()}
    jc = jinit_cache(jcfg, B, CLEN, jopts)
    _, jc = _jforward(jp, jcfg, jnp.asarray(tokens[:, :T]), cache=jc,
                      opts=jopts, mode="prefill", **jx)
    tc = init_cache(cfg, B, CLEN, opts, device="cpu")
    _, tc = forward(p, cfg, torch.as_tensor(tokens[:, :T]), cache=tc,
                    opts=opts, mode="prefill", **tx)
    before = [x.clone() for x in leaves(tc["layers"])]
    nxt = tokens[:, T:T + 1]
    ro = JOptions(dtype=jnp.float32, remat=False, max_abs_pos=96,
                  readonly_cache=True)
    want, jfresh = _jforward(jp, jcfg, jnp.asarray(nxt), cache=jc, opts=ro,
                             mode="decode", **jx)
    got, fresh = forward(p, cfg, torch.as_tensor(nxt), cache=tc,
                         opts=ModelOptions(dtype=torch.float32, remat=False,
                                           max_abs_pos=96,
                                           readonly_cache=True),
                         mode="decode", **tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # the input cache: not one bit written, its position unmoved
    assert tc["pos"] == T and fresh is not tc and fresh["pos"] == T + 1
    assert all(torch.equal(a, b) for a, b in
               zip(before, leaves(tc["layers"])))
    jl = _jax_fresh(jcfg, jfresh)
    assert len(fresh["layers"]) == len(jl) == len(layer_kinds(cfg))
    for i, (g, w) in enumerate(zip(fresh["layers"], jl)):
        _compare_fresh(g, w, T + 1, f"{arch} layer {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_readonly_steps_with_appends_match_written_decode(arch):
    """Four read-only steps, each step's fresh pieces appended out of
    band, against four written-cache decode steps on the same tokens
    (teacher-forced): the logits agree, and the appended cache holds the
    written one's entries."""
    _, (cfg, p), tokens, extra = _setup(arch, seed=5)
    opts = ModelOptions(dtype=torch.float32, remat=False, max_abs_pos=96)
    ro = ModelOptions(dtype=torch.float32, remat=False, max_abs_pos=96,
                      readonly_cache=True)
    tx = {k: torch.as_tensor(v) for k, v in extra.items()}
    caches = []
    for _ in range(2):
        c = init_cache(cfg, B, CLEN, opts, device="cpu")
        _, c = forward(p, cfg, torch.as_tensor(tokens[:, :T]), cache=c,
                       opts=opts, mode="prefill", **tx)
        caches.append(c)
    written, appended = caches
    for t in range(T, T + 4):
        tok = torch.as_tensor(tokens[:, t:t + 1])
        want, written = forward(p, cfg, tok, cache=written, opts=opts,
                                mode="decode", **tx)
        got, fresh = forward(p, cfg, tok, cache=appended, opts=ro,
                             mode="decode", **tx)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL)
        appended = append_readonly(appended, fresh)
        assert appended["pos"] == written["pos"] == t + 1
    for a, w in zip(leaves(appended["layers"]), leaves(written["layers"])):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_readonly_ring_and_recurrent_layers_leave_the_input():
    """recurrentgemma-9b: a local layer's ring ignores the read-only flag,
    as in the JAX package (its new ring comes back), and the recurrent
    state is replaced; the input cache is still untouched, and the
    logits are the written decode's."""
    cfg = configs.get_reduced("recurrentgemma-9b")
    opts = ModelOptions(dtype=torch.float32, remat=False)
    ro = ModelOptions(dtype=torch.float32, remat=False, readonly_cache=True)
    p = init_params(cfg, torch.Generator().manual_seed(1), opts,
                    device="cpu")
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab, (B, T + 1)).astype(np.int32))
    c = init_cache(cfg, B, CLEN, opts, device="cpu")
    _, c = forward(p, cfg, toks[:, :T], cache=c, opts=opts, mode="prefill")
    before = [x.clone() for x in leaves(c["layers"])]
    got, fresh = forward(p, cfg, toks[:, T:], cache=c, opts=ro,
                         mode="decode")
    assert all(torch.equal(a, b) for a, b in
               zip(before, leaves(c["layers"])))
    want, _ = forward(p, cfg, toks[:, T:], cache=c, opts=opts,
                      mode="decode")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)
    assert all("k_new" not in layer for layer in fresh["layers"])
