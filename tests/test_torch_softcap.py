"""The logit softcap on the CPU: K-F's and K-B's plain versions with a cap
(``flash_attention_plain`` / ``flash_attention_bwd_plain``, ``softcap=``)
against the JAX package's ``_sdpa`` and ``jax.grad`` of it, at caps 30
and 50 in every mask form (causal, windowed, non-causal, nq ≠ nk, rows
that see no key); the capped reduced models' logits (train, prefill and
decode: llama3.2-3b, recurrentgemma-9b's windowed prefill and ring
decode, whisper-small's cross-attention) and gradients against JAX
``forward`` and ``value_and_grad(loss_fn)``; MLA unchanged by a cap, as
in the JAX package.

Tolerance: float32, attention outputs and each gradient within 1e-5 of
their largest entry (tiled online softmax vs XLA's full softmax, sums in
other orders; tanh on both sides is float32); logits within 2e-5 abs +
2e-5 rel and gradients within 2e-5 of each leaf's largest entry, as
``test_torch_lm.py`` and ``test_torch_train.py`` hold the uncapped
models. JAX's softmax over a row that sees no key is NaN; the port's row
is 0 and its gradient 0, and the other rows are held against JAX on
those rows alone. The models' weights are the port's ``init_params``,
carried into the JAX layout (``torch_parity.params_to_jax``: the JAX
init, run eagerly, compiles each random draw); ``_jax_sdpa`` is jitted,
one compile a shape and cap. The file's tests take ~17 s of the run (the
JAX side's compiles)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.models import ModelOptions as JOptions  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models.layers import _sdpa  # noqa: E402
from repro.train import loss_fn as jloss_fn  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import flash_attention as kf  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import (ModelOptions, forward, init_cache,  # noqa: E402
                                init_params, params_from_jax)
from repro_torch.train.train_step import loss_and_grads  # noqa: E402
from repro_torch.tree import leaves_with_path, path_str  # noqa: E402
from torch_parity import params_to_jax  # noqa: E402

REL = 1e-5
ATOL = RTOL = 2e-5
CAPS = (30.0, 50.0)

# b, nq, nk, h, kvh, d, causal, window; inputs scaled so the logits reach
# the cap's bend (|s| up to ~40)
CASES = {
    "causal-gqa": (2, 40, 40, 4, 2, 16, True, None),
    "windowed": (2, 70, 70, 4, 1, 16, True, 9),
    "non-causal": (2, 20, 45, 4, 4, 16, False, None),
    "decode-over-cache": (3, 5, 37, 6, 2, 8, True, None),
    "no-key-rows": (2, 40, 30, 4, 2, 16, True, None),
}


def _inputs(b, nq, nk, h, kvh, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, nq, h, d)).astype(np.float32) * 3
    k = rng.standard_normal((b, nk, kvh, d)).astype(np.float32) * 3
    v = rng.standard_normal((b, nk, kvh, d)).astype(np.float32)
    do = rng.standard_normal((b, nq, h, d)).astype(np.float32)
    return q, k, v, do


def _close(got, want, what):
    lim = REL * float(np.abs(want).max()) + 1e-12
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= lim, f"{what}: {err:.3e} > {lim:.3e}"


@functools.partial(jax.jit, static_argnames=("causal", "window", "cap"))
def _jax_sdpa(q, k, v, *, causal, window, cap):
    rep = q.shape[2] // k.shape[2]
    return _sdpa(q, jnp.repeat(k, rep, 2), jnp.repeat(v, rep, 2),
                 causal=causal, window=window,
                 q_offset=k.shape[1] - q.shape[1], softcap=cap)


def _seen(case):
    """The first row that sees a key (rows before it see none)."""
    b, nq, nk = CASES[case][:3]
    return max(0, nq - nk)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("case", list(CASES))
def test_capped_forward_matches_sdpa(case, cap):
    b, nq, nk, h, kvh, d, causal, window = CASES[case]
    q, k, v, _ = _inputs(b, nq, nk, h, kvh, d)
    kw = dict(causal=causal, window=window)
    got, lse = kf.flash_attention_plain(*map(torch.as_tensor, (q, k, v)),
                                        bq=16, bk=16, softcap=cap,
                                        return_lse=True, **kw)
    s0 = _seen(case)
    assert bool((got[:, :s0] == 0).all())
    assert bool(torch.isinf(lse[:, :, :s0]).all())
    want = _jax_sdpa(*map(jnp.asarray, (q[:, s0:], k, v)), cap=cap, **kw)
    _close(got[:, s0:].numpy(), want, f"{case} cap {cap}")
    # the cap moves the output (the logits reach its bend)
    plain = kf.flash_attention_plain(*map(torch.as_tensor, (q, k, v)),
                                     bq=16, bk=16, **kw)
    assert float((plain - got).abs().max()) > 1e-3


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("case", list(CASES))
def test_capped_backward_matches_jax_grad(case, cap):
    b, nq, nk, h, kvh, d, causal, window = CASES[case]
    q, k, v, do = _inputs(b, nq, nk, h, kvh, d, seed=1)
    kw = dict(causal=causal, window=window)
    tq, tk, tv, tdo = map(torch.as_tensor, (q, k, v, do))
    out, lse = kf.flash_attention_plain(tq, tk, tv, return_lse=True, bq=16,
                                        bk=16, softcap=cap, **kw)
    got = kf.flash_attention_bwd_plain(tq, tk, tv, out, tdo, lse, bq=16,
                                       bk=16, softcap=cap, **kw)
    # FlashAttentionFn (what training runs) carries the cap both ways
    ts = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    fn_out = ops.flash_attention(*ts, softcap=cap, **kw)
    assert torch.equal(fn_out, kf.flash_attention_plain(
        tq, tk, tv, softcap=cap, **kw))
    fn_grads = torch.autograd.grad(fn_out, ts, tdo)
    s0 = _seen(case)
    assert bool((got[0][:, :s0] == 0).all())

    def f(q, k, v):
        return jnp.sum(_jax_sdpa(q, k, v, cap=cap, **kw) * do[:, s0:])
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q[:, s0:], k, v)))
    for name, g, fg, j in zip("qkv", got, fn_grads, want):
        assert bool(torch.isfinite(g).all())
        g = g[:, s0:] if name == "q" else g
        fg = fg[:, s0:] if name == "q" else fg
        _close(g.numpy(), np.asarray(j), f"d{name} {case} cap {cap}")
        _close(fg.numpy(), np.asarray(j), f"Fn d{name} {case} cap {cap}")


# ------------------------------------------------------- reduced models
def _pair(arch, cap, seed=0):
    """The capped reduced config in both packages, on the same weights
    (the port's ``init_params``, carried into the JAX layout)."""
    jcfg = dataclasses.replace(jget_reduced(arch), attn_logit_softcap=cap)
    jopts = JOptions(dtype=jnp.float32, remat=False, max_abs_pos=96)
    cfg = dataclasses.replace(configs.get_reduced(arch),
                              attn_logit_softcap=cap)
    p = init_params(cfg, torch.Generator().manual_seed(seed),
                    ModelOptions(dtype=torch.float32, remat=False,
                                 max_abs_pos=96), device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, params_to_jax(p, cfg))
    return (jcfg, jp, jopts), (cfg, p)


def _extra(cfg, b, rng):
    if cfg.n_enc_layers:
        return {"enc_frames": rng.standard_normal(
            (b, cfg.enc_len, cfg.d_model)).astype(np.float32)}
    return {}


def _close_logits(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


_jforward = jax.jit(jforward, static_argnums=(1,),
                    static_argnames=("opts", "mode"))


@pytest.mark.parametrize("arch,decode", [("llama3.2-3b", True),
                                         ("recurrentgemma-9b", True),
                                         ("whisper-small", False)])
def test_capped_model_matches_jax(arch, decode):
    """Train-mode logits of the capped reduced model (whisper's
    bidirectional encoder and cross-attention, recurrentgemma's windowed
    layers), and for the decoder-only models a prefill and three decode
    steps (recurrentgemma's ring wraps: its reduced window is shorter than
    the run), against the JAX package's, on the same weights."""
    (jcfg, jp, jopts), (cfg, p) = _pair(arch, 50.0)
    opts = ModelOptions(dtype=torch.float32, remat=False, max_abs_pos=96)
    rng = np.random.default_rng(2)
    b, t = 2, 12
    tokens = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    extra = _extra(cfg, b, rng)
    jx = {k: jnp.asarray(v) for k, v in extra.items()}
    tx = {k: torch.as_tensor(v) for k, v in extra.items()}
    want, _ = _jforward(jp, jcfg, jnp.asarray(tokens), opts=jopts, **jx)
    got, _ = forward(p, cfg, torch.as_tensor(tokens), opts=opts, **tx)
    _close_logits(got, want, f"{arch} train")
    uncapped = dataclasses.replace(cfg, attn_logit_softcap=0.0)
    assert float((forward(p, uncapped, torch.as_tensor(tokens), opts=opts,
                          **tx)[0] - got).abs().max()) > 0
    if not decode:
        return
    clen = t + 3
    jc = jinit_cache(jcfg, b, clen, jopts)
    tc = init_cache(cfg, b, clen, opts, device="cpu")
    got, tc = forward(p, cfg, torch.as_tensor(tokens), cache=tc, opts=opts,
                      mode="prefill")
    if cfg.local_window:
        # the JAX ring takes one token a step (ROADMAP C19): fill it so
        for i in range(t):
            want, jc = _jforward(jp, jcfg, jnp.asarray(tokens[:, i:i + 1]),
                                 cache=jc, opts=jopts, mode="decode")
        got = got[:, -1:]
    else:
        want, jc = _jforward(jp, jcfg, jnp.asarray(tokens), cache=jc,
                             opts=jopts, mode="prefill")
    _close_logits(got, want, f"{arch} prefill")
    for step in range(3):
        nxt = np.argmax(np.asarray(want)[:, -1], -1)[:, None].astype(np.int32)
        want, jc = _jforward(jp, jcfg, jnp.asarray(nxt), cache=jc,
                             opts=jopts, mode="decode")
        got, tc = forward(p, cfg, torch.as_tensor(nxt), cache=tc,
                          opts=opts, mode="decode")
        _close_logits(got, want, f"{arch} decode {step}")


def test_capped_gradients_match_jax():
    """``loss_and_grads`` of the capped reduced llama3.2-3b (z-loss on,
    masked labels; attention's gradient through K-B's plain version with
    the cap) against ``jax.value_and_grad(loss_fn)``."""
    (jcfg, jp, jopts), (cfg, p) = _pair("llama3.2-3b", 30.0)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)}
    batch["labels"][0, :3] = -1
    jl, jg = jax.jit(jax.value_and_grad(jloss_fn), static_argnums=(1, 3, 4))(
        jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, jopts, 1e-4)
    opts = ModelOptions(dtype=torch.float32, remat=True, max_abs_pos=96)
    loss, grads = loss_and_grads(p, cfg, {k: torch.as_tensor(v) for k, v
                                          in batch.items()}, opts, 1e-4)
    np.testing.assert_allclose(float(loss), float(jl), rtol=2e-6)
    want = dict(leaves_with_path(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jg), cfg, device="cpu")))
    got = dict(leaves_with_path(grads))
    assert got.keys() == want.keys()
    for path, b in want.items():
        lim = 2e-5 * float(b.abs().max()) + 1e-12
        assert float((got[path] - b).abs().max()) <= lim, path_str(path)


def test_mla_takes_no_cap():
    """deepseek-v2-lite-16b with a cap: MLA's attention is uncapped in
    both of its forms (the JAX package passes ``softcap=0.0`` to the
    expanded form and has no cap in the absorbed one), so the capped
    config's logits are the uncapped config's bits in train mode, prefill
    and decode (``test_torch_mla.py`` holds those against JAX)."""
    cfg = dataclasses.replace(configs.get_reduced("deepseek-v2-lite-16b"),
                              attn_logit_softcap=50.0)
    uncapped = dataclasses.replace(cfg, attn_logit_softcap=0.0)
    opts = ModelOptions(dtype=torch.float32, remat=False, max_abs_pos=96)
    p = init_params(cfg, torch.Generator().manual_seed(0), opts,
                    device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 10)).astype(np.int32))
    assert torch.equal(forward(p, cfg, tokens, opts=opts)[0],
                       forward(p, uncapped, tokens, opts=opts)[0])
    tc = init_cache(cfg, 2, 12, opts, device="cpu")
    tu = init_cache(cfg, 2, 12, opts, device="cpu")
    for step, tok in enumerate((tokens, tokens[:, -1:], tokens[:, :1])):
        mode = "prefill" if step == 0 else "decode"
        got, tc = forward(p, cfg, tok, cache=tc, opts=opts, mode=mode)
        ref, tu = forward(p, uncapped, tok, cache=tu, opts=opts, mode=mode)
        assert torch.equal(got, ref), mode
