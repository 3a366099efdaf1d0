"""The port's train path (``repro_torch.train``, ``data``,
``launch.train``, ``ModelOptions.remat``) against the JAX package's, on
the CPU at reduced sizes, and the JAX train tests mirrored in the port.

* The LM batches are numpy on both sides: equal bit for bit.
* The optimizers are fed the same numpy gradients (the JAX parameters and
  states carried across with ``models.params_from_jax`` /
  ``opt_state_from_jax``). Updated parameters are compared on shared
  gradients, not after a full train step: a near-zero gradient flips
  AdamW's first update by 2·lr. Tolerance: float32 parameters within
  1e-6 abs + 1e-5 rel after three steps (the two packages take the
  global norm's and Adafactor's means in other orders; each step's
  update is ~lr = 1e-2, so 1e-6 is ~1e-4 of an update); bf16 parameters
  within one bf16 ulp (2⁻⁷ relative) of the JAX ones, their float32
  masters as above; states within 1e-6 of each leaf's largest entry.
* The train step's loss and every gradient against
  ``jax.value_and_grad(loss_fn)`` on five families: loss within 2e-6
  rel, each gradient leaf within 2e-5 of its largest entry (float32
  products and the attention's online softmax summed in other orders;
  the largest seen is 2.6e-6).

Single-process time ~65 s, most of it the JAX side's jit compiles (five
``value_and_grad``, six optimizer updates)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import synthetic_lm_batch as jsynthetic  # noqa: E402
from repro.models import ModelOptions as JOptions  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.train import OptConfig as JOptConfig  # noqa: E402
from repro.train import loss_fn as jloss_fn  # noqa: E402
from repro.train import lr_schedule as jlr_schedule  # noqa: E402
from repro.train import make_optimizer as jmake_optimizer  # noqa: E402
from repro.train.optimizer import _clip as jclip  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.data import (DataConfig, batch_iterator,  # noqa: E402
                              synthetic_lm_batch)
from repro_torch.models import (ModelOptions, init_params,  # noqa: E402
                                opt_state_from_jax, params_from_jax)
from repro_torch.train import (OptConfig, TrainConfig,  # noqa: E402
                               checkpoint, lr_schedule, make_optimizer,
                               make_train_step)
from repro_torch.train.optimizer import clip_scale  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402
from repro_torch.tree import leaves_with_path, path_str  # noqa: E402

OPTS = ModelOptions(dtype=torch.float32, remat=False, max_abs_pos=96)
GRAD_REL = 2e-5
FAMILIES = ("llama3.2-3b", "deepseek-v2-lite-16b", "recurrentgemma-9b",
            "whisper-small", "qwen2-vl-7b")


def _np(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(jnp.asarray(x, jnp.float32)), tree)


def _jparams(arch, seed=0, dtype=jnp.float32):
    jcfg = jget_reduced(arch)
    return jcfg, jinit_params(jcfg, jax.random.PRNGKey(seed),
                              JOptions(dtype=dtype, remat=False,
                                       max_abs_pos=96))


def _inputs(cfg, b, rng):
    kw = {}
    if cfg.n_enc_layers:
        kw["enc_frames"] = rng.standard_normal(
            (b, cfg.enc_len, cfg.d_model)).astype(np.float32)
    if cfg.n_vision_embeds:
        kw["vision_embeds"] = rng.standard_normal(
            (b, cfg.n_vision_embeds, cfg.d_model)).astype(np.float32)
    return kw


def _batch(cfg, b, t, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32),
             **_inputs(cfg, b, rng)}
    batch["labels"][0, :3] = -1          # masked labels
    return batch


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _by_path(got, want):
    """The two trees' leaves paired by path (key order may differ: the JAX
    side's dicts come back sorted)."""
    a, b = dict(leaves_with_path(got)), dict(leaves_with_path(want))
    assert a.keys() == b.keys() and a
    return [(path, a[path], b[path]) for path in b]


def _assert_leaves_rel(got, want, rel):
    """Each leaf within ``rel`` of its largest magnitude (optimizer states,
    whose entries span many orders of magnitude)."""
    for path, a, b in _by_path(got, want):
        assert a.shape == b.shape, path_str(path)
        if b.numel():
            lim = rel * float(b.abs().max())
            assert float((a - b).abs().max()) <= lim, path_str(path)


def _assert_trees(got, want, atol, rtol):
    for path, a, b in _by_path(got, want):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=atol, rtol=rtol,
                                   err_msg=path_str(path))


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("kw", [
    dict(vocab=100, seq_len=16, global_batch=4, seed=9),
    dict(vocab=512, seq_len=33, global_batch=6, seed=1, n_shards=3,
         shard=2)])
def test_synthetic_lm_batch_matches_jax(kw):
    for step in (0, 5, 123):
        got = synthetic_lm_batch(DataConfig(**kw), step)
        want = jsynthetic(JDataConfig(**kw), step)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    it = batch_iterator(DataConfig(**kw), start_step=5)
    np.testing.assert_array_equal(next(it)["tokens"], synthetic_lm_batch(
        DataConfig(**kw), 5)["tokens"])
    np.testing.assert_array_equal(next(it)["labels"], synthetic_lm_batch(
        DataConfig(**kw), 6)["labels"])


# ------------------------------------------------------------- optimizer
def test_lr_schedule_matches_jax():
    """Warmup, cosine decay and the floor, in float32 on both sides."""
    cfg = dict(lr=3e-3, warmup_steps=10, decay_steps=100, min_lr_ratio=0.1)
    steps = np.array([0, 1, 5, 9, 10, 11, 37, 99, 100, 101, 400], np.int32)
    got = lr_schedule(OptConfig(**cfg), torch.as_tensor(steps))
    want = np.asarray(jlr_schedule(JOptConfig(**cfg), jnp.asarray(steps)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert got[0] == 0.0
    np.testing.assert_array_equal(got[-3:].numpy(),
                                  np.float32(3e-3) * np.float32(0.1))


def test_clip_matches_jax():
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(7, 5)).astype(np.float32) * 3,
            "b": [rng.normal(size=(11,)).astype(np.float32)]}
    jg, jnorm = jclip(jax.tree_util.tree_map(jnp.asarray, tree), 1.0)
    tg = {"a": torch.as_tensor(tree["a"]), "b": [torch.as_tensor(
        tree["b"][0])]}
    scale, norm = clip_scale(tg, 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    assert float(scale) < 1.0
    np.testing.assert_allclose((tg["a"] * scale).numpy(),
                               np.asarray(jg["a"]), rtol=2e-6)
    scale, _ = clip_scale(tg, 1e9)
    assert float(scale) == 1.0


def _grads_like(np_params, rng, step):
    """Seeded gradients of the parameters' shapes: a spread of scales
    and a few exact zeros, so that the clip and AdamW's near-zero
    regime both occur."""
    def one(x):
        g = rng.standard_normal(x.shape).astype(np.float32)
        g *= np.float32(10.0 ** rng.integers(-4, 1))
        flat = g.reshape(-1)
        flat[::7] = 0.0
        return g
    return jax.tree_util.tree_map(one, np_params)


@pytest.mark.parametrize("arch,name,dtype", [
    ("qwen2-vl-7b", "adamw", "float32"),
    ("deepseek-v2-lite-16b", "adafactor", "float32"),
    ("recurrentgemma-9b", "adafactor", "float32"),
    ("whisper-small", "adafactor", "float32"),
    ("llama3.2-3b", "adafactor", "float32"),
    ("llama3.2-3b", "adamw", "bfloat16")])
def test_optimizer_matches_jax(arch, name, dtype):
    """Three steps of the port's optimizer against the JAX one on the same
    gradients — Adafactor's per-layer leaves of ndim <= 1 factored across
    the group's layers as JAX's stacked leaves are — and a JAX state
    carried across after step 1 (``opt_state_from_jax``) continued in the
    port for steps 2 and 3."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jcfg, jp = _jparams(arch, seed=1, dtype=jdt)
    cfg = configs.get_reduced(arch)
    # bf16: no clip (scale 1). Under jit XLA fuses the bf16 product g·scale
    # into the float32 upcast and never rounds it to bf16, which the JAX
    # source (and the port) does; at scale 1 both are exact. The float32
    # cases clip.
    ocfg = dict(name=name, lr=1e-2, warmup_steps=2, decay_steps=10,
                grad_clip=1e9 if dtype == "bfloat16" else 1.0)
    jinit, jupdate = jmake_optimizer(JOptConfig(**ocfg))
    jupdate = jax.jit(jupdate)
    init, update = make_optimizer(OptConfig(**ocfg), cfg)
    js = jinit(jp)
    p = params_from_jax(_np(jp), cfg, dtype=tdt, device="cpu")
    s = init(p)
    rng = np.random.default_rng(7)
    ptol = dict(atol=1e-6, rtol=1e-5)
    for step in range(3):
        g_np = _grads_like(_np(jp), rng, step)
        jg = jax.tree_util.tree_map(lambda x, ref: jnp.asarray(x, ref.dtype),
                                    g_np, jp)
        jp, js, jm = jupdate(jg, js, jp)
        p, s, m = update(params_from_jax(_np(jg), cfg, dtype=tdt,
                                         device="cpu"), s, p)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        want = params_from_jax(_np(jp), cfg, dtype=tdt, device="cpu")
        if tdt == torch.bfloat16:
            # one bf16 ulp (<= 2^-7 relative) of masters that agree to
            # float32 rounding: the two roundings may fall apart
            _assert_trees(p, want, atol=1e-6, rtol=2 ** -7)
            _assert_trees(s["master"], opt_state_from_jax(
                _np(js), cfg, device="cpu")["master"], **ptol)
        else:
            _assert_trees(p, want, **ptol)
        if step == 0:
            # the JAX state carried across, continued in the port
            cp = want
            cs = opt_state_from_jax(_np(js), cfg, device="cpu")
            assert int(cs["step"]) == 1
            _assert_leaves_rel(cs, s, 1e-6)
        else:
            cp, cs, _ = update(params_from_jax(_np(jg), cfg, dtype=tdt,
                                               device="cpu"), cs, cp)
            _assert_trees(cp, want, atol=1e-6,
                          rtol=2 ** -7 if tdt == torch.bfloat16 else 1e-5)
    if name == "adafactor":
        # the stacked leaves: 1-D per layer, factored across the layers
        stacked = s["stacked"]
        assert stacked and all(set(e) == {"vr", "vc"} for e in
                               stacked.values())
        jv = _np(js)["v"]
        for key, e in stacked.items():
            node = jv
            for part in key.split("/"):
                node = node[int(part)] if isinstance(node, list) else \
                    node[part]
            for part in ("vr", "vc"):
                lim = 1e-6 * float(np.abs(node[part]).max())
                assert np.abs(e[part].numpy() - node[part]).max() <= lim


# ------------------------------------------------------------ train step
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch):
    """Loss, grad norm and every gradient of the train step's
    ``loss_and_grads`` (z-loss on, masked labels) against
    ``jax.value_and_grad(loss_fn)``, on the same weights and batch."""
    jcfg, jp = _jparams(arch)
    batch = _batch(jcfg, 2, 24, seed=3)
    jopts = JOptions(dtype=jnp.float32, remat=False, max_abs_pos=96)
    jl, jg = jax.jit(jax.value_and_grad(jloss_fn), static_argnums=(1, 3, 4))(
        jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, jopts, 1e-4)
    cfg = configs.get_reduced(arch)
    p = params_from_jax(_np(jp), cfg, device="cpu")
    loss, grads = loss_and_grads(p, cfg, _torch_batch(batch), OPTS, 1e-4)
    np.testing.assert_allclose(float(loss), float(jl), rtol=2e-6)
    want = params_from_jax(_np(jg), cfg, device="cpu")
    for path, a, b in _by_path(grads, want):
        lim = GRAD_REL * float(b.abs().max()) + 1e-12
        assert float((a - b).abs().max()) <= lim, path_str(path)
    from repro.train.optimizer import global_norm as jglobal_norm
    from repro_torch.train import global_norm
    np.testing.assert_allclose(float(global_norm(grads)),
                               float(jglobal_norm(jg)), rtol=1e-5)


def test_remat_gives_the_same_gradients():
    """``ModelOptions.remat`` recomputes each layer in the backward pass
    and changes no bit of the loss or the gradients."""
    cfg = configs.get_reduced("deepseek-v2-lite-16b")
    p = init_params(cfg, torch.Generator().manual_seed(0), OPTS,
                    device="cpu")
    batch = _torch_batch(_batch(cfg, 2, 16, seed=4))
    l0, g0 = loss_and_grads(p, cfg, batch, OPTS, 1e-4)
    l1, g1 = loss_and_grads(p, cfg, batch, dataclasses.replace(
        OPTS, remat=True), 1e-4)
    assert torch.equal(l0, l1)
    for (_, a), (_, b) in zip(leaves_with_path(g0), leaves_with_path(g1)):
        assert torch.equal(a, b)


def test_accum_equivalence():
    """accum=4 over 4 microbatches == accum=1 over the concatenated batch
    (the JAX ``test_train.py`` case)."""
    cfg = configs.get_reduced("llama3.2-3b")
    params = init_params(cfg, torch.Generator().manual_seed(3), OPTS,
                         device="cpu")
    b, t = 8, 16
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (b, t)))
    labs = torch.as_tensor(rng.integers(0, cfg.vocab, (b, t)))
    ocfg = OptConfig(grad_clip=1e9)
    oi1, s1 = make_train_step(cfg, TrainConfig(opt=ocfg, accum=1,
                                               z_loss=0.0), OPTS)
    oi4, s4 = make_train_step(cfg, TrainConfig(opt=ocfg, accum=4,
                                               z_loss=0.0), OPTS)
    p1, _, m1 = s1(params, oi1(params), {"tokens": toks, "labels": labs})
    p4, _, m4 = s4(params, oi4(params), {"tokens": toks.reshape(4, 2, t),
                                         "labels": labs.reshape(4, 2, t)})
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    _assert_trees(p1, p4, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_step(arch):
    """One optimizer step on the CPU (the JAX ``test_models.py`` case):
    loss and grad norm finite, parameters change, no NaNs; the inputs are
    not modified."""
    cfg = configs.get_reduced(arch)
    params = init_params(cfg, torch.Generator().manual_seed(1), OPTS,
                         device="cpu")
    before = {path: t.clone() for path, t in leaves_with_path(params)}
    opt_init, step = make_train_step(cfg, TrainConfig(accum=1, z_loss=1e-4),
                                     OPTS)
    batch = _torch_batch(_batch(cfg, 2, 16, seed=1))
    new_params, _, metrics = step(params, opt_init(params), batch)
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    assert not torch.equal(params["embed"], new_params["embed"])
    for (path, new), (_, old) in zip(leaves_with_path(new_params),
                                     leaves_with_path(params)):
        assert bool(torch.isfinite(new).all()), path_str(path)
        assert new.dtype == old.dtype
        assert torch.equal(old, before[path]), path_str(path)


def test_loss_decreases_tiny_model():
    """End-to-end sanity: 30 steps on learnable synthetic data (the JAX
    ``test_models.py`` case)."""
    cfg = configs.get_reduced("llama3.2-3b")
    params = init_params(cfg, torch.Generator().manual_seed(6), OPTS,
                         device="cpu")
    tcfg = TrainConfig(opt=OptConfig(lr=3e-3, warmup_steps=5,
                                     decay_steps=100), accum=1)
    opt_init, step = make_train_step(cfg, tcfg, OPTS)
    opt = opt_init(params)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)
    losses = []
    for i in range(30):
        params, opt, m = step(params, opt,
                              _torch_batch(synthetic_lm_batch(dcfg, i)))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::6]


# ------------------------------------------------------------ checkpoint
def test_checkpoint_roundtrip(tmp_path):
    """Parameters and an AdamW state, float32 and bfloat16 (stored as its
    bits), restored bit for bit, in the JAX package's layout."""
    cfg = configs.get_reduced("qwen3-14b")
    d = str(tmp_path / "ckpt")
    tree = {}
    for dtype in (torch.float32, torch.bfloat16):
        p = init_params(cfg, torch.Generator().manual_seed(5),
                        dataclasses.replace(OPTS, dtype=dtype), device="cpu")
        init, _ = make_optimizer(OptConfig())
        tree[str(dtype)] = {"params": p, "opt": init(p)}
    checkpoint.save(d, 7, tree)
    assert sorted(os.listdir(d)) == ["step_00000007"]
    assert "manifest.json" in os.listdir(os.path.join(d, "step_00000007"))
    restored, step = checkpoint.restore(d, tree)
    assert step == 7
    pairs = list(zip(leaves_with_path(tree), leaves_with_path(restored)))
    assert any(a.dtype == torch.bfloat16 for (_, a), _ in pairs)
    for (pa, a), (pb, b) in pairs:
        assert pa == pb and a.dtype == b.dtype
        assert torch.equal(a, b), path_str(pa)
    # the keys of the JAX package's layout: "/"-joined tree paths
    import json
    with open(os.path.join(d, "step_00000007", "manifest.json")) as f:
        manifest = json.load(f)
    assert "torch.bfloat16/params/layers/0/attn/q/w" in manifest["leaves"]
    assert manifest["leaves"]["torch.bfloat16/params/embed"]["dtype"] == \
        "bfloat16"


def test_checkpoint_atomicity(tmp_path):
    """The latest checkpoint survives a failed save (tmp dir + rename)."""
    d = str(tmp_path / "ckpt")
    checkpoint.save(d, 1, {"x": torch.ones(4)})
    assert checkpoint.latest_step(d) == 1
    # a crashed save leaves only a .tmp dir — latest_step must ignore it
    os.makedirs(os.path.join(d, ".tmp_ckpt_dead"), exist_ok=True)
    assert checkpoint.latest_step(d) == 1
    restored, _ = checkpoint.restore(d, {"x": torch.zeros(4)})
    np.testing.assert_array_equal(restored["x"].numpy(), np.ones(4))


def test_checkpoint_shape_mismatch_and_missing_leaf_raise(tmp_path):
    d = str(tmp_path / "ckpt")
    checkpoint.save(d, 0, {"x": torch.ones(4)})
    with pytest.raises(ValueError):
        checkpoint.restore(d, {"x": torch.zeros(5)})
    with pytest.raises(KeyError):
        checkpoint.restore(d, {"x": torch.zeros(4), "y": torch.zeros(1)})
    assert checkpoint.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), {"x": torch.zeros(4)})


def test_launcher_restart_is_bitwise(tmp_path):
    """``launch.train``: 4 steps straight and 2 + ``--restart`` + 2 (a
    checkpoint every 2 steps, stateless data replay) end at the same
    bits, for AdamW's state too."""
    from repro_torch.launch import train as launch_train
    base = ["--arch", "llama3.2-3b", "--reduced", "--device", "cpu",
            "--seq", "16", "--batch", "2", "--ckpt-every", "2"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    straight = launch_train.main(base + ["--steps", "4", "--ckpt-dir", a])
    launch_train.main(base + ["--steps", "2", "--ckpt-dir", b])
    resumed = launch_train.main(base + ["--steps", "4", "--ckpt-dir", b,
                                        "--restart"])
    assert resumed["start"] == 2 and len(resumed["loss"]) == 2
    assert resumed["loss"] == straight["loss"][2:]
    cfg = configs.get_reduced("llama3.2-3b")
    p = init_params(cfg, torch.Generator().manual_seed(0), OPTS,
                    device="cpu")
    target = {"params": p, "opt": make_optimizer(OptConfig())[0](p)}
    ra, _ = checkpoint.restore(a, target, step=4)
    rb, _ = checkpoint.restore(b, target, step=4)
    for (path, x), (_, y) in zip(leaves_with_path(ra), leaves_with_path(rb)):
        assert torch.equal(x, y), path_str(path)
