"""Training the dense decoders over a ``("data", "model")`` mesh: 2-D FSDP
× tensor parallelism (``repro_torch.train.fsdp`` with a model axis wider
than 1), the vocab-parallel loss (``train_step.cross_entropy_terms_tp``)
and the autograd pair of the model comm (``distributed.mesh.psum_fwd`` /
``psum_bwd``), on the CPU.

* The 2-D trainer at ``(1, 2)``, ``(2, 2)`` and ``(1, 4)`` for the
  reduced llama3.2-3b (tied embedding), qwen3-14b (per-head q / k
  norms), nemotron-4-15b (LayerNorm, squared ReLU) and granite-34b (one
  kv head on every shard), float32, AdamW, two steps, against one device
  on the same weights and batches: each step's loss within 1e-6 rel and
  grad norm within 1e-5 rel; each step's gradients, reduced and joined
  into whole leaves, against one device's at the same parameters: within
  1e-5 of each leaf's norm and every element within ``NOISE`` of the
  leaf's largest; every parameter after two steps within 2e-6 abs +
  1e-5 rel (the FSDP test's limits) of one device's optimizer run on
  the 2-D step's own gradients, and of the one-device run but for the
  elements whose one-device gradient sits at float32 noise (module note
  below).
* The vocab-parallel loss against ``cross_entropy_terms`` on the
  gathered logits, with masked labels and the z-loss, at t = 2 and 4,
  its logits' gradients against autograd's of the whole loss; a
  vocabulary that t does not divide (509) keeps the head whole, and the
  trainer runs that way against one device as above.
* A 2 × 2 gloo ``GroupComm`` (4 processes, each running backward from
  its own copy of the loss) gives ``LocalComm``'s bits: the first
  step's gradients, the parameters after two steps and the losses.
* The JAX ``make_train_step`` jitted with ``param_shardings`` on forced
  ``(2, 2)`` and ``(1, 4)`` host meshes (4 devices, one subprocess a
  mesh, ``torch_parity.params_to_jax``'s weights) against the port's trainer
  on the same meshes: three losses and grad norms within 1e-5 rel, for
  llama and granite.
* A checkpoint saved at ``(2, 2)`` restored at ``(1, 4)``, ``(4, 1)`` and
  on one device, bitwise; the layout's records (``tp_holders``,
  ``tp_partial``) and the refusals (Adafactor over ``"model"``, the
  A10c archs).

The float32 noise note. The 2-D step computes one device's function in
another order: the shards' partial outputs of o and down are summed
after rounding, the vocabulary's Σ exp in parts, the replicated
activations' gradients in parts. Its gradients sit ~1e-6 of each leaf's
largest from one device's (the data-parallel step's ~1.5e-7). AdamW's
first steps divide a gradient by its own magnitude plus ``eps`` = 1e-8,
so an element whose gradient is itself at that noise (on the reduced
llama, ``layers/0/attn/k/w[44, 21]`` is -8.7e-9 against a median of
2.6e-3) moves by a different part of a step on the two layouts; two or
three of ~150,000 elements pass the FSDP test's element limit that way
(up to 9× it). Those elements (one-device gradient at either step not 0
but below ``NOISE`` of its leaf's largest: 0.02–0.15 % of the elements
here, fixed by the one-device run) are left out of the comparison with the one-device run (the test asserts
that they are fewer than 1 in 400), and no further: like every element
they are held to the FSDP test's limit against one device's AdamW fed
with the 2-D step's own gradients (the 2-D run's parameters sit within
1 % of that limit of it), and their gradients, like every element's, to
``NOISE`` of their leaf's largest (the 2-D step's sit within 2e-6 of it
on each case). A wrong update there (its sign, ``eps``, a holder sum
that misses a shard) fails one or the other.

The module takes ~25 s of the run: the JAX subprocesses (~20 s each
with their imports and two compiles) start with the module's first test
and run beside the others (~13 s, the gloo group ~6 s of it).
"""
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.data import DataConfig, synthetic_lm_batch  # noqa: E402
from repro_torch.distributed import LocalComm, make_mesh  # noqa: E402
from repro_torch.distributed.mesh import psum_bwd, psum_fwd  # noqa: E402
from repro_torch.distributed.tensor_parallel import (  # noqa: E402
    tp_holders, tp_partial, unsplit_blocks)
from repro_torch.models import init_params  # noqa: E402
from repro_torch.train import (OptConfig, TrainConfig, checkpoint,  # noqa: E402
                               make_train_step)
from repro_torch.train.fsdp import FSDPTrainer  # noqa: E402
from repro_torch.train.optimizer import adamw_init, adamw_update  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    cross_entropy_terms, cross_entropy_terms_tp, loss_and_grads)
from repro_torch.tree import (get_path, leaves,  # noqa: E402
                              leaves_with_path, path_str)
from torch_fsdp import OPTS, batch, tcfg  # noqa: E402
from torch_parity import params_to_jax  # noqa: E402
from torch_tp import TRAIN_ARCHS, tp_train_worker, train_2d  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
DENSE = ("llama3.2-3b", "qwen3-14b", "nemotron-4-15b", "granite-34b")
MESHES = ((1, 2), (2, 2), (1, 4))
NOISE = 1e-5            # of a leaf's largest gradient: at float32 noise


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's tensors are a few KiB: one intra-op thread computes
    them as fast, beside the JAX subprocess; restored after."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _mesh(shape):
    return make_mesh(shape, ("data", "model"),
                     devices=["cpu"] * (shape[0] * shape[1]))


def _weights(cfg, seed=0):
    return init_params(cfg, torch.Generator().manual_seed(seed), OPTS,
                       device="cpu")


def _one_device(cfg, steps):
    """One device's run: (parameters after each step, metrics, the
    gradient of each step at the parameters it started from)."""
    p = _weights(cfg)
    init, step = make_train_step(cfg, tcfg("adamw"), OPTS)
    s, ps, ms, gs = init(p), [p], [], []
    for i in range(steps):
        b = batch(cfg, i)
        gs.append(loss_and_grads(ps[-1], cfg, b, OPTS, tcfg("adamw").z_loss,
                                 (b["labels"] >= 0).sum().float())[1])
        p, s, m = step(p, s, b)
        ps.append(p)
        ms.append(m)
    return ps, ms, gs


def _at_noise(g):
    """The elements of a gradient that are not 0 but below ``NOISE`` of
    its largest."""
    a = g.abs()
    return (a > 0) & (a < NOISE * a.max())


def _grads_at(cfg, params, i):
    """One device's gradient of step ``i``'s batch at ``params``."""
    b = batch(cfg, i)
    return loss_and_grads(params, cfg, b, OPTS, tcfg("adamw").z_loss,
                          (b["labels"] >= 0).sum().float())[1]


def _off(a, b):
    """Elements of ``a`` past the FSDP test's limit of ``b``."""
    return (a - b).abs() > 2e-6 + 1e-5 * b.abs()


def _check_run(cfg, tr, local, ms, raws, starts, what):
    ps, wm, gs = _one_device(cfg, 2)
    for m, w in zip(ms, wm):
        np.testing.assert_allclose(float(m["loss"]), float(w["loss"]),
                                   rtol=1e-6, err_msg=what)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(w["grad_norm"]), rtol=1e-5,
                                   err_msg=what)
    # each step's gradients, reduced and joined into whole leaves, against
    # one device's at the parameters the step started from
    grads = [tr.whole(tr._reduce(r, False)) for r in raws]
    for i, (g2, start) in enumerate(zip(grads, starts)):
        for (path, g), w in zip(leaves_with_path(g2),
                                leaves(_grads_at(cfg, start, i))):
            gap = float((g - w).norm() / w.norm())
            assert gap <= 1e-5, (what, i, path_str(path), gap)
            top = float((g - w).abs().max() / w.abs().max())
            assert top <= NOISE, (what, i, path_str(path), top)
    # one device's AdamW on the 2-D step's own gradients
    replay, state = starts[0], adamw_init(starts[0])
    for g in grads:
        replay, state, _ = adamw_update(g, state, replay, tcfg("adamw").opt)
    noisy = total = 0
    for (path, a), r, b, g1, g2 in zip(leaves_with_path(tr.whole(local)),
                                       leaves(replay), leaves(ps[2]),
                                       leaves(gs[0]), leaves(gs[1])):
        assert not bool(_off(a, r).any()), (what, path_str(path), "replay")
        quiet = _at_noise(g1) | _at_noise(g2)
        bad = _off(a, b) & ~quiet
        assert not bool(bad.any()), (what, path_str(path),
                                     float((a - b).abs()[bad].max()))
        noisy += int(quiet.sum())
        total += b.numel()
    assert noisy < total // 400, (what, noisy, total)
    return noisy


# ------------------------------------------------ the trainer vs one device
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", DENSE)
def test_2d_trainer_matches_one_device(arch, shape):
    cfg = configs.get_reduced(arch)
    tr, local, states, ms, raws, starts = train_2d(cfg, _mesh(shape), 2)
    _check_run(cfg, tr, local, ms, raws, starts, f"{arch} {shape}")
    # each shard holds its model shard's part, cut again over "data"
    d, t = shape
    whole = tr.whole(local)
    for (path, x), full in zip(leaves_with_path(local[0]), leaves(whole)):
        spec = tr.specs
        for k in path:
            spec = spec[k]
        held = len(tp_holders(path, spec, cfg, t))
        parts = (d if "data" in spec else 1) * held
        assert x.numel() * parts == full.numel(), path_str(path)
    assert states[0]["mu"]["embed"].shape == local[0]["embed"].shape


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_2d_trainer_with_a_whole_head(shape):
    """A vocabulary that t does not divide: the embedding and the head
    stay whole on every shard, which computes the whole loss itself."""
    import dataclasses
    cfg = dataclasses.replace(configs.get_reduced("llama3.2-3b"), vocab=509)
    tr, local, _, ms, raws, starts = train_2d(cfg, _mesh(shape), 2)
    assert local[0]["embed"].shape[0] == 509
    _check_run(cfg, tr, local, ms, raws, starts, f"vocab 509 {shape}")


# ------------------------------------------------- the vocab-parallel loss
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
@pytest.mark.parametrize("vocab", [512, 509])
@pytest.mark.parametrize("t", [2, 4])
def test_vocab_parallel_loss(t, vocab, z_loss):
    rng = np.random.default_rng(t * vocab)
    logits = torch.as_tensor(rng.normal(size=(3, 7, vocab)) * 4,
                             dtype=torch.float32)
    labels = torch.as_tensor(rng.integers(0, vocab, (3, 7)))
    labels[0, :3] = -1
    labels[2, 6] = vocab - 1               # the last shard's last column
    num, count = cross_entropy_terms(logits, labels, z_loss)
    comm = LocalComm(_mesh((1, t))).axis("model")
    cut = vocab % t == 0
    per = vocab // t if cut else vocab
    parts = [logits[..., m * per:(m + 1) * per].clone().requires_grad_(True)
             if cut else logits.clone().requires_grad_(True)
             for m in range(t)]
    terms = cross_entropy_terms_tp(parts, [labels] * t, comm, vocab, z_loss)
    whole = logits.clone().requires_grad_(True)
    want = torch.autograd.grad(cross_entropy_terms(whole, labels,
                                                   z_loss)[0], whole)[0]
    got = torch.autograd.grad([n for n, _ in terms], parts)
    for (n, c), g, m in zip(terms, got, range(t)):
        np.testing.assert_allclose(float(n.detach()), float(num), rtol=1e-6)
        assert int(c) == int(count) == 21 - 3
        w = want[..., m * per:(m + 1) * per] if cut else want
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-7,
                                   rtol=1e-5)
        assert bool((g[0, :3] == 0).all())       # masked rows


def test_conjugate_pair_gradients():
    """``psum_fwd``'s backward is each shard's own output gradient,
    ``psum_bwd``'s the sum of every shard's; without autograd they are
    the plain psum and nothing (the serving path's bits)."""
    comm = LocalComm(_mesh((1, 3))).axis("model")
    xs = [torch.full((2,), float(j + 1), requires_grad=True)
          for j in range(3)]
    ys = psum_fwd(comm, xs)
    assert all(torch.equal(y, torch.full((2,), 6.0)) for y in ys)
    gs = torch.autograd.grad([y.sum() * (j + 1) for j, y in enumerate(ys)],
                             xs)
    assert [float(g[0]) for g in gs] == [1.0, 2.0, 3.0]
    ys = psum_bwd(comm, xs)
    assert all(torch.equal(y, x) for y, x in zip(ys, xs))
    gs = torch.autograd.grad([y.sum() * (j + 1) for j, y in enumerate(ys)],
                             xs)
    assert [float(g[0]) for g in gs] == [6.0, 6.0, 6.0]
    with torch.no_grad():
        plain = [x.detach() for x in xs]
        assert psum_bwd(comm, plain) == plain
        assert all(torch.equal(a, b) for a, b in
                   zip(psum_fwd(comm, plain), comm.psum(plain)))


# --------------------------------------------------- gloo against LocalComm
def test_group_comm_matches_local_comm(tmp_path):
    import torch.multiprocessing as mp
    world = 4
    out_path = str(tmp_path / "pg")
    ctx = mp.start_processes(tp_train_worker,
                             args=(world, str(tmp_path / "fs"), out_path),
                             nprocs=world, join=False, start_method="spawn")
    t0 = time.monotonic()
    while not ctx.join(timeout=5):
        if time.monotonic() - t0 > 240.0:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the 4-process group did not finish")
    for arch in TRAIN_ARCHS:
        cfg = configs.get_reduced(arch)
        _, local, _, ms, raws, _ = train_2d(cfg, _mesh((2, 2)), 2)
        for rank in range(world):
            got = np.load(f"{out_path}.{rank}.npz")
            assert np.array_equal(got[f"{arch}/loss"], np.array(
                [float(m["loss"]) for m in ms]))
            for tag, tree in (("g", raws[0][rank]), ("p", local[rank])):
                for path, x in leaves_with_path(tree):
                    assert np.array_equal(got[f"{arch}/{tag}/"
                                              f"{path_str(path)}"],
                                          x.numpy()), (arch, tag, rank, path)


# ---------------------------------------------------------- checkpoints
def test_checkpoint_moves_between_layouts(tmp_path):
    """Saved at ``(2, 2)`` (the single-device layout), restored at ``(1,
    4)``, ``(4, 1)`` and on one device: every leaf's bits."""
    cfg = configs.get_reduced("qwen3-14b")
    tr, local, states, _, _, _ = train_2d(cfg, _mesh((2, 2)), 2)
    tr.save(str(tmp_path), 2, local, states)
    saved_p = tr.whole(local)
    saved_o = tr.whole(states, tr.state_specs(states))
    for shape in ((1, 4), (4, 1)):
        other = FSDPTrainer(cfg, tcfg("adamw"), OPTS, _mesh(shape))
        p, s = other.init(_weights(cfg, seed=1))
        p, s, at = other.restore(str(tmp_path), p, s)
        assert at == 2
        for a, b in zip(leaves(other.whole(p)), leaves(saved_p)):
            assert torch.equal(a, b), shape
        for a, b in zip(leaves(other.whole(s, other.state_specs(s))),
                        leaves(saved_o)):
            assert torch.equal(a, b), shape
        # and each shard's parts are the cut of the saved leaves
        want_p, want_s = other.place(saved_p, saved_o)
        for a, b in zip(leaves(p), leaves(want_p)):
            assert torch.equal(a, b), shape
        for a, b in zip(leaves(s), leaves(want_s)):
            assert torch.equal(a, b), shape
    p1 = _weights(cfg, seed=1)
    init, _ = make_train_step(cfg, tcfg("adamw"), OPTS)
    got, at = checkpoint.restore(str(tmp_path), {"params": p1,
                                                 "opt": init(p1)})
    assert at == 2
    for a, b in zip(leaves(got["params"]), leaves(saved_p)):
        assert torch.equal(a, b)
    for a, b in zip(leaves(got["opt"]), leaves(saved_o)):
        assert torch.equal(a, b)


# ---------------------------------------------------------- the records
@pytest.mark.parametrize("t", [2, 4, 8])
@pytest.mark.parametrize("arch", DENSE)
def test_holders_and_partial_leaves(arch, t):
    """Which model shards hold each leaf's part, and whose gradients are
    partial: the kv heads on several shards where t passes kvh, the q /
    k norms always; the norms (and a whole head) whole on every shard."""
    from repro_torch.distributed import Mesh, param_pspecs
    cfg = configs.get_arch(arch)
    kvh = cfg.n_kv_heads
    tree = {"final_norm": {"scale": torch.empty(8)},
            "embed": torch.empty(cfg.vocab, 8),
            "layers": [{"norm1": {"scale": torch.empty(8)},
                        "attn": {"q": {"w": torch.empty(8, cfg.n_heads
                                                        * cfg.dh)},
                                 "k": {"w": torch.empty(8, kvh * cfg.dh)},
                                 "q_norm": {"scale": torch.empty(cfg.dh)}}}]}
    specs = param_pspecs(tree, Mesh(["cpu"] * (2 * t), (2, t),
                                    ("data", "model")), mode="train",
                         kv_heads_divide=kvh % t == 0)
    for path, _ in leaves_with_path(tree):
        holders = tp_holders(path, get_path(specs, path), cfg, t)
        name = path_str(path)
        if name.endswith(("q/w", "embed")):
            assert holders == [[m] for m in range(t)], name
            assert not tp_partial(path, cfg, t)
        elif name.endswith("k/w") and t > kvh:
            r = t // kvh
            assert holders == [list(range(g * r, (g + 1) * r))
                               for g in range(kvh)]
            assert tp_partial(path, cfg, t)
        elif name.endswith("k/w"):
            assert holders == [[m] for m in range(t)]
            assert not tp_partial(path, cfg, t)
        else:
            assert holders == [list(range(t))], name
            assert tp_partial(path, cfg, t) == name.endswith("q_norm/scale")


def test_refusals():
    """Adafactor over a model axis wider than 1 names A10e (training MoE
    / MLA over "model"); an arch whose blocks training does not split
    (deepseek's MoE and MLA: A10e; xlstm's recurrent kinds: A10c), and an
    extent that does not split the heads, raise; a ``(n, 1)`` mesh runs
    the data-parallel step."""
    cfg = configs.get_reduced("llama3.2-3b")
    ada = TrainConfig(opt=OptConfig(name="adafactor"))
    with pytest.raises(ValueError, match="A10e"):
        FSDPTrainer(cfg, ada, OPTS, _mesh((1, 2)))
    FSDPTrainer(cfg, ada, OPTS, _mesh((2, 1)))
    with pytest.raises(ValueError, match="A10e"):
        FSDPTrainer(configs.get_reduced("deepseek-v2-lite-16b"),
                    tcfg("adamw"), OPTS, _mesh((1, 2)))
    with pytest.raises(ValueError, match="A10c"):
        FSDPTrainer(configs.get_reduced("xlstm-350m"),
                    tcfg("adamw"), OPTS, _mesh((1, 2)))
    with pytest.raises(ValueError, match="does not split"):
        FSDPTrainer(cfg, tcfg("adamw"), OPTS, _mesh((1, 3)))
    others = [a for a in ARCH_IDS
              if unsplit_blocks(configs.get_arch(a), "train")]
    assert "arctic-480b" in others and not set(DENSE) & set(others)


# ---------------------------------------------------------- the JAX step
_JAX_SCRIPT = """
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_reduced
    from repro.core.jax_compat import make_mesh
    from repro.data import DataConfig, synthetic_lm_batch
    from repro.distributed.sharding import axis_rules, param_shardings
    from repro.models import ModelOptions, init_params
    from repro.train import OptConfig, TrainConfig, make_train_step

    opts = ModelOptions(dtype=jnp.float32, remat=False, max_abs_pos=4096)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=10,
                                     decay_steps=3))
    out = {}
    for arch in sys.argv[2].split(","):
        cfg = get_reduced(arch)
        z = np.load(f"{sys.argv[1]}/{arch}.npz")
        tree = jax.tree_util.tree_structure(jax.eval_shape(
            lambda k: init_params(cfg, k, opts), jax.random.PRNGKey(0)))
        opt_init, step_fn = make_train_step(cfg, tcfg, opts)
        for shape in [tuple(map(int, sys.argv[3].split("x")))]:
            mesh = make_mesh(shape, ("data", "model"))
            losses, norms = [], []
            with mesh, axis_rules(mesh):
                params = jax.tree_util.tree_unflatten(tree, [
                    jnp.asarray(z[f"arr_{i}"]) for i in range(len(z.files))])
                params = jax.device_put(params, param_shardings(
                    params, mesh,
                    kv_heads_divide=cfg.n_kv_heads % shape[1] == 0))
                opt = opt_init(params)
                dcfg = DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=4)
                jstep = jax.jit(step_fn, donate_argnums=(0, 1))
                for i in range(3):
                    batch = {k: jnp.asarray(v) for k, v in
                             synthetic_lm_batch(dcfg, i).items()}
                    params, opt, m = jstep(params, opt, batch)
                    losses.append(float(m["loss"]))
                    norms.append(float(m["grad_norm"]))
            out[f"{arch} {shape}"] = {"loss": losses, "grad_norm": norms}
    print(json.dumps({"runs": out, "devices": len(jax.devices())}))
"""
JAX_ARCHS = ("llama3.2-3b", "granite-34b")
JAX_MESHES = ((2, 2), (1, 4))


@pytest.fixture(scope="module", autouse=True)
def jax_2d_run(tmp_path_factory):
    """The JAX steps' subprocesses (``_JAX_SCRIPT``, one a mesh), started
    with the module's first test so that their imports and compiles
    overlap the other tests; ``test_jax_2d_step_matches_port`` reads
    them. The weights are the port's ``init_params``, carried into the
    JAX layout."""
    import jax
    d = tmp_path_factory.mktemp("jax_2d")
    weights = {}
    for arch in JAX_ARCHS:
        cfg = configs.get_reduced(arch)
        weights[arch] = p = _weights(cfg)
        np.savez(d / f"{arch}.npz",
                 *jax.tree_util.tree_leaves(params_to_jax(p, cfg)))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    procs = {}
    for shape in JAX_MESHES:
        tag = "x".join(map(str, shape))
        with open(d / f"out_{tag}.txt", "w") as out, \
                open(d / f"err_{tag}.txt", "w") as err:
            procs[shape] = subprocess.Popen(
                [sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT), str(d),
                 ",".join(JAX_ARCHS), tag], env=env, stdout=out,
                stderr=err, text=True)
    run = dict(procs=procs, dir=d, weights=weights)
    yield run
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("shape", JAX_MESHES)
@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_jax_2d_step_matches_port(jax_2d_run, arch, shape):
    run = jax_2d_run
    tag = "x".join(map(str, shape))
    rc = run["procs"][shape].wait(timeout=400)
    assert rc == 0, (run["dir"] / f"err_{tag}.txt").read_text()[-3000:]
    ref = json.loads((run["dir"] / f"out_{tag}.txt").read_text().strip()
                     .splitlines()[-1])
    assert ref["devices"] == 4
    want = ref["runs"][f"{arch} {shape}"]
    cfg = configs.get_reduced(arch)
    tr = FSDPTrainer(cfg, TrainConfig(opt=OptConfig(
        lr=1e-3, warmup_steps=10, decay_steps=3)), OPTS, _mesh(shape))
    local, states = tr.init(run["weights"][arch])
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    for i in range(3):
        b = {k: torch.as_tensor(v)
             for k, v in synthetic_lm_batch(dcfg, i).items()}
        local, states, m = tr.step(local, states, b)
        np.testing.assert_allclose(float(m["loss"]), want["loss"][i],
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   want["grad_norm"][i], rtol=1e-5)
