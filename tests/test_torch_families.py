"""The port's other LM families against the JAX package's, on the
reduced forms of recurrentgemma-9b (hybrid: RG-LRU and local attention
over a ring cache), xlstm-350m (ssm: mLSTM and sLSTM), whisper-small
(audio: encoder-decoder with cross-attention) and qwen2-vl-7b (vlm:
M-RoPE, stub vision embeddings).

The JAX parameters (float32, seeded) are carried across with
``models.params_from_jax``; the same numpy tokens go through both
packages' ``forward`` in train mode, in prefill and in decode steps. The
JAX package cannot prefill a local layer's ring cache (ROADMAP C19), so
recurrentgemma's prefill + decode is held against JAX's token-by-token
fill of the ring, and the ring wrap (24 tokens through a window of 16,
as ``tests/test_models.py``) token by token on both sides. The port's
attention is K-F's plain version on the CPU.

Tolerance: logits within 2e-5 abs + 2e-5 relative in float32 (the
packages sum in different orders: XLA's dot vs torch's matmul, the full
softmax vs the online one, RG-LRU's ``associative_scan`` vs a
Hillis–Steele scan, RG-LRU's gates in float64 here); the worst seen at
these seeds is 7.2e-6 abs, 0.29 of the limit. Greedy tokens are compared exactly. About 45 s
(JAX's forward jitted once per shape and mode)."""
import dataclasses
import functools

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
from repro.models.model import encode as jencode  # noqa: E402
from repro.serve import BatchedServer as JServer  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import (  # noqa: E402
    ModelOptions, count_params, encode, forward, init_cache, init_params,
    params_from_jax)
from repro_torch.serve import (  # noqa: E402
    BatchedServer, ServeConfig, make_serve_step)

FAMILIES = ("recurrentgemma-9b", "xlstm-350m", "whisper-small",
            "qwen2-vl-7b")
ATOL = RTOL = 2e-5
OPTS = ModelOptions(dtype=torch.float32)
JOPTS = JOptions(dtype=jnp.float32, remat=False)


@functools.cache
def _pair(arch, seed=0):
    """(JAX config, params), (port config, params): the same weights."""
    jcfg = jget_reduced(arch)
    jp = jinit_params(jcfg, jax.random.PRNGKey(seed), JOPTS)
    cfg = configs.get_reduced(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    return (jcfg, jp), (cfg, params_from_jax(np_params, cfg, device="cpu"))


@functools.cache
def _jstep(jcfg, mode):
    """JAX's ``forward`` jitted for one config and mode."""
    return jax.jit(functools.partial(jforward, cfg=jcfg, opts=JOPTS,
                                     mode=mode))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _frames(cfg, b=2, seed=5):
    return np.random.default_rng(seed).normal(
        size=(b, cfg.enc_len, cfg.d_model)).astype(np.float32)


def _extras(cfg, b=2):
    """(port, JAX) keyword arguments the arch needs: whisper's frames."""
    if not cfg.n_enc_layers:
        return {}, {}
    fr = _frames(cfg, b)
    return {"enc_frames": torch.from_numpy(fr)}, \
        {"enc_frames": jnp.asarray(fr)}


def _jdecode(jcfg, jp, toks, jcache, **jex):
    """JAX's token-by-token decode of ``toks`` (B, T) from ``jcache``:
    the logits (B, T, V) and the cache."""
    step = _jstep(jcfg, "decode")
    outs = []
    for i in range(toks.shape[1]):
        lg, jcache = step(jp, tokens=jnp.asarray(toks[:, i:i + 1]),
                          cache=jcache, **jex)
        outs.append(np.asarray(lg[:, 0]))
    return np.stack(outs, 1), jcache


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_jax(arch):
    """Train mode over 70 tokens (mLSTM: a padded second chunk; the local
    window of 16 cut in), then a prefill of 60 into a cache and ten
    decode steps: logits within the tolerance; the parameter count
    equal. recurrentgemma's prefill + decode against JAX's token-by-token
    fill (C19)."""
    (jcfg, jp), (cfg, params) = _pair(arch)
    assert count_params(params) == sum(
        x.size for x in jax.tree_util.tree_leaves(jp))
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 70)) \
        .astype(np.int32)
    ex, jex = _extras(cfg)
    ops.reset_launch_counts()
    got, _ = forward(params, cfg, torch.from_numpy(toks), opts=OPTS, **ex)
    want, _ = _jstep(jcfg, "train")(jp, tokens=jnp.asarray(toks), **jex)
    _close(got, want)
    assert set(ops.launch_counts().values()) == {0}

    cache = init_cache(cfg, 2, 74, OPTS, device="cpu")
    jcache = jinit_cache(jcfg, 2, 74, JOPTS)
    got, cache = forward(params, cfg, torch.from_numpy(toks[:, :60]),
                         cache=cache, opts=OPTS, mode="prefill", **ex)
    if arch == "recurrentgemma-9b":
        want, jcache = _jdecode(jcfg, jp, toks[:, :60], jcache)
    else:
        want, jcache = _jstep(jcfg, "prefill")(
            jp, tokens=jnp.asarray(toks[:, :60]), cache=jcache, **jex)
    _close(got, want)
    rest = []
    for t in range(60, 70):
        lg, cache = forward(params, cfg, torch.from_numpy(toks[:, t:t + 1]),
                            cache=cache, opts=OPTS, mode="decode", **ex)
        rest.append(lg[:, 0].numpy())
    want, _ = _jdecode(jcfg, jp, toks[:, 60:], jcache, **jex)
    _close(np.stack(rest, 1), want)
    assert cache["pos"] == 70


def test_ring_wrap_matches_jax_token_by_token():
    """recurrentgemma's local layer decodes 24 tokens through a ring of 16
    slots from an empty cache on both sides (``tests/test_models.py``'s
    case): the logits as the JAX package's (their argmax equal), and as
    the port's own windowed forward; the ring's slots hold JAX's keys."""
    (jcfg, jp), (cfg, params) = _pair("recurrentgemma-9b")
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (1, 24)) \
        .astype(np.int32)
    cache = init_cache(cfg, 1, 26, OPTS, device="cpu")
    assert cache["layers"][2]["k"].shape[1] == cfg.local_window == 16
    outs = []
    for i in range(24):
        lg, cache = forward(params, cfg, torch.from_numpy(toks[:, i:i + 1]),
                            cache=cache, opts=OPTS, mode="decode")
        outs.append(lg[:, 0].numpy())
    got = np.stack(outs, 1)
    want, jcache = _jdecode(jcfg, jp, toks, jinit_cache(jcfg, 1, 26, JOPTS))
    _close(got, want)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    full, _ = forward(params, cfg, torch.from_numpy(toks), opts=OPTS)
    _close(got, full.numpy())
    ring = jcache[0]["l2_local"]
    _close(cache["layers"][2]["k"], np.asarray(ring["k"])[0])
    _close(cache["layers"][2]["v"], np.asarray(ring["v"])[0])


def test_ring_prefill_then_decode_matches_token_by_token():
    """A prefill of 40 tokens from position 0 (past the window of 16)
    leaves the ring JAX's token-by-token fill leaves; decoding on from it
    gives JAX's logits (argmax equal throughout). A prefill past position
    0 raises, as in JAX."""
    (jcfg, jp), (cfg, params) = _pair("recurrentgemma-9b")
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 45)) \
        .astype(np.int32)
    cache = init_cache(cfg, 2, 50, OPTS, device="cpu")
    got, cache = forward(params, cfg, torch.from_numpy(toks[:, :40]),
                         cache=cache, opts=OPTS, mode="prefill")
    want, jcache = _jdecode(jcfg, jp, toks[:, :40],
                            jinit_cache(jcfg, 2, 50, JOPTS))
    _close(got, want)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    ring = jcache[0]["l2_local"]
    _close(cache["layers"][2]["k"], np.asarray(ring["k"])[0])
    rest = []
    for t in range(40, 45):
        lg, cache = forward(params, cfg, torch.from_numpy(toks[:, t:t + 1]),
                            cache=cache, opts=OPTS, mode="decode")
        rest.append(lg[:, 0].numpy())
    want, _ = _jdecode(jcfg, jp, toks[:, 40:], jcache)
    _close(np.stack(rest, 1), want)
    np.testing.assert_array_equal(np.stack(rest, 1).argmax(-1),
                                  want.argmax(-1))
    with pytest.raises(ValueError, match="ring cache"):
        forward(params, cfg, torch.from_numpy(toks[:, :3]), cache=cache,
                opts=OPTS, mode="prefill")


def test_whisper_encode_and_enc_out():
    """``encode`` as the JAX package's; ``make_serve_step``'s prefill and
    decode with ``enc_out=`` as JAX's with ``enc_out=`` (the frames
    encoded once); the decoder without frames or ``enc_out`` raises."""
    (jcfg, jp), (cfg, params) = _pair("whisper-small")
    fr = _frames(cfg, 3, seed=8)
    enc = encode(params, cfg, torch.from_numpy(fr), OPTS)
    jenc = jencode(jp, jcfg, jnp.asarray(fr), JOPTS)
    _close(enc, jenc)
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (3, 12)) \
        .astype(np.int32)
    prefill, decode = make_serve_step(cfg, ServeConfig(), OPTS)
    cache = init_cache(cfg, 3, 16, OPTS, device="cpu")
    got, cache = prefill(params, torch.from_numpy(toks[:, :9]), cache,
                         enc_out=enc)
    want, jcache = _jstep(jcfg, "prefill")(
        jp, tokens=jnp.asarray(toks[:, :9]),
        cache=jinit_cache(jcfg, 3, 16, JOPTS), enc_out=jenc)
    _close(got, want[:, -1])
    rest = []
    for t in range(9, 12):
        lg, cache = decode(params, torch.from_numpy(toks[:, t:t + 1]), cache,
                           enc_out=enc)
        rest.append(lg.numpy())
    want, _ = _jdecode(jcfg, jp, toks[:, 9:], jcache, enc_out=jenc)
    _close(np.stack(rest, 1), want)
    _close(cache["layers"][0]["xk"],
           np.asarray(jcache[0]["l0_xattn"]["xk"])[0])
    with pytest.raises(ValueError, match="enc_frames or enc_out"):
        forward(params, cfg, torch.from_numpy(toks), opts=OPTS)


def test_qwen2_vl_vision_embeds_and_mrope_positions():
    """qwen2-vl with stub vision embeddings over the first positions and
    (3, B, T) positions whose temporal, height and width ids differ
    (a 2 × 2 patch grid, then text shifted on): train mode and a prefill
    as JAX's, decode steps with shifted positions as JAX's."""
    (jcfg, jp), (cfg, params) = _pair("qwen2-vl-7b")
    rng = np.random.default_rng(10)
    b, t, nv = 2, 20, cfg.n_vision_embeds
    toks = rng.integers(0, cfg.vocab, (b, t + 3)).astype(np.int32)
    vis = rng.normal(size=(b, nv, cfg.d_model)).astype(np.float32)
    pos = np.zeros((3, b, t + 3), np.int32)
    pos[1, :, :nv] = np.arange(nv) // 2           # height of the patch grid
    pos[2, :, :nv] = np.arange(nv) % 2            # width
    text = np.arange(t + 3 - nv) + 2
    pos[:, :, nv:] = text + np.array([0, 5])[None, :, None]   # per row shift
    ex = dict(vision_embeds=torch.from_numpy(vis))
    jex = dict(vision_embeds=jnp.asarray(vis))
    got, _ = forward(params, cfg, torch.from_numpy(toks[:, :t]), opts=OPTS,
                     positions=torch.from_numpy(pos[:, :, :t]), **ex)
    want, _ = _jstep(jcfg, "train")(jp, tokens=jnp.asarray(toks[:, :t]),
                                    positions=jnp.asarray(pos[:, :, :t]),
                                    **jex)
    _close(got, want)
    plain, _ = forward(params, cfg, torch.from_numpy(toks[:, :t]), opts=OPTS)
    assert not np.allclose(plain.numpy(), got.numpy())
    cache = init_cache(cfg, b, t + 4, OPTS, device="cpu")
    jcache = jinit_cache(jcfg, b, t + 4, JOPTS)
    got, cache = forward(params, cfg, torch.from_numpy(toks[:, :t]),
                         cache=cache, opts=OPTS, mode="prefill",
                         positions=torch.from_numpy(pos[:, :, :t]), **ex)
    want, jcache = _jstep(jcfg, "prefill")(
        jp, tokens=jnp.asarray(toks[:, :t]), cache=jcache,
        positions=jnp.asarray(pos[:, :, :t]), **jex)
    _close(got, want)
    step = _jstep(jcfg, "decode")
    for s in range(t, t + 3):
        got, cache = forward(params, cfg, torch.from_numpy(toks[:, s:s + 1]),
                             cache=cache, opts=OPTS, mode="decode",
                             positions=torch.from_numpy(pos[:, :, s:s + 1]))
        want, jcache = step(jp, tokens=jnp.asarray(toks[:, s:s + 1]),
                            cache=jcache,
                            positions=jnp.asarray(pos[:, :, s:s + 1]))
        _close(got, want)


def _prompts(vocab):
    rng = np.random.default_rng(2)
    return [rng.integers(0, vocab, n).astype(np.int32)
            for n in (5, 9, 3, 12, 7)]


@pytest.mark.parametrize("arch", ["xlstm-350m", "qwen2-vl-7b"])
def test_batched_server_matches_jax(arch):
    """5 ragged prompts, batch 2 (three waves), 6 greedy tokens: the same
    tokens as the JAX server's (qwen2-vl as text, as JAX serves it)."""
    (jcfg, jp), (cfg, params) = _pair(arch)
    prompts = _prompts(cfg.vocab)
    want = JServer(jcfg, JServeConfig(batch=2), jp, JOPTS).generate(
        prompts, max_new_tokens=6)
    got = BatchedServer(cfg, ServeConfig(batch=2), params, OPTS).generate(
        prompts, max_new_tokens=6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_batched_server_recurrentgemma_and_whisper():
    """recurrentgemma through ``BatchedServer`` (which the JAX package's
    cannot serve, C19): its tokens are the argmax of the logits of the
    port's own train-mode forward over the growing sequence. whisper
    through ``BatchedServer`` raises (no encoder output; C20), as the
    launcher says before it starts."""
    _, (cfg, params) = _pair("recurrentgemma-9b")
    prompts = _prompts(cfg.vocab)[:2]
    got = BatchedServer(cfg, ServeConfig(batch=2), params, OPTS).generate(
        prompts, max_new_tokens=5)
    tmax = max(len(p) for p in prompts)
    seq = np.zeros((2, tmax), np.int64)
    for r, p in enumerate(prompts):
        seq[r, tmax - len(p):] = p
    for step in range(5):
        lg, _ = forward(params, cfg, torch.from_numpy(seq), opts=OPTS)
        tok = lg[:, -1].argmax(-1).numpy()
        np.testing.assert_array_equal(tok, [g[step] for g in got])
        seq = np.concatenate([seq, tok[:, None]], 1)
    _, (wcfg, wparams) = _pair("whisper-small")
    with pytest.raises(ValueError, match="enc_frames or enc_out"):
        BatchedServer(wcfg, ServeConfig(batch=2), wparams, OPTS).generate(
            _prompts(wcfg.vocab), max_new_tokens=2)
    from repro_torch.launch import serve as launch_serve
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "whisper-small", "--reduced",
                           "--device", "cpu"])
    outs = launch_serve.main(["--arch", "xlstm-350m", "--reduced",
                              "--device", "cpu", "--requests", "2",
                              "--new-tokens", "2"])
    assert [o.shape for o in outs] == [(2,)] * 2


def test_init_params_matches_jax_shapes():
    """``init_params`` draws the JAX package's shapes and dtypes for every
    family, the encoder, learned positions and float32 recurrent leaves
    included (bfloat16 model)."""
    flat = jax.tree_util.tree_leaves
    for arch in FAMILIES:
        jcfg = jget_reduced(arch)
        jp = jinit_params(jcfg, jax.random.PRNGKey(0),
                          JOptions(dtype=jnp.bfloat16, remat=False))
        np_params = jax.tree_util.tree_map(
            lambda x: np.asarray(x, np.float32), jp)
        cfg = configs.get_reduced(arch)
        got = init_params(cfg, torch.Generator().manual_seed(0),
                          ModelOptions(dtype=torch.bfloat16), device="cpu")
        ported = params_from_jax(np_params, cfg, dtype=torch.bfloat16,
                                 device="cpu")
        assert [(tuple(t.shape), t.dtype) for t in flat(got)] == \
            [(tuple(t.shape), t.dtype) for t in flat(ported)]
        assert count_params(got) == sum(x.size for x in flat(jp))
        assert {str(t.dtype).removeprefix("torch.") for t in flat(got)} \
            == {str(x.dtype) for x in flat(jp)}
