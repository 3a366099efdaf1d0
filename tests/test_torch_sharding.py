"""The LM's mesh layout (``repro_torch.distributed.sharding``) and the train
step over a mesh (``repro_torch.train.fsdp``) on the CPU.

* Placements against the JAX ``param_pspecs`` on ``AbstractMesh``\\ es of
  2 and 3 axes, for every arch's reduced config and its full-size shapes
  (the port's tree as meta tensors from ``jax.eval_shape``: the serve
  mode's 128 MiB budget only bites at full size), in both modes, with and
  without ``fsdp_over_pod`` and ``kv_heads_divide``. A JAX leaf stacked
  over a group's layers is compared, its leading ``None`` dropped, with
  each of its layers' leaves in the port.
* ROADMAP C21: on a 1-axis mesh (the JAX training launcher's host mesh)
  the JAX ``param_pspecs`` raises ``KeyError: 'model'``; the port
  resolves ``"kv"`` to ``None``.
* The FSDP step at 2 and 4 shards against one device (AdamW and
  Adafactor): loss within 1e-6 rel, grad norm within 1e-5 rel, every
  parameter after two steps within 2e-6 abs + 1e-5 rel (the shards sum
  their rows' gradients in another order than one device's batch, and
  the norm's sums run in another order); a gloo ``GroupComm`` of 2 and 4
  processes gives ``LocalComm``'s bits.
* The JAX train step on a forced (2, 1) ``("data", "model")`` host mesh
  (``param_shardings`` + jit; one subprocess) against the port's 2
  shards over the same weights and batches: three losses and grad norms
  within 1e-5 rel.
* A checkpoint of 2 shards restored onto 1 (``checkpoint.restore``) and
  onto 4 shards: the restored parts are the saved leaves' bits, and a
  step after it agrees with the 2-shard run's next step as above.

The weights of the parity tests are the port's ``init_params``, carried
into the JAX layout (``torch_parity.params_to_jax``). The JAX subprocess
(~15 s) starts with the module's first test and runs beside the others;
the gloo groups' workers (``torch_fsdp``) import no JAX. The module's
tests take ~21 s of the run."""
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.distributed.sharding import param_pspecs as jparam_pspecs  # noqa: E402
from repro.models import ModelOptions as JOptions  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.data import DataConfig, synthetic_lm_batch  # noqa: E402
from repro_torch.distributed import Mesh, make_mesh, param_pspecs  # noqa: E402
from repro_torch.distributed import param_shardings  # noqa: E402
from repro_torch.distributed.sharding import local_slices  # noqa: E402
from repro_torch.models import (ModelOptions, init_params,  # noqa: E402
                                params_from_jax)
from repro_torch.train import (OptConfig, TrainConfig, checkpoint,  # noqa: E402
                               make_train_step)
from repro_torch.train.fsdp import FSDPTrainer  # noqa: E402
from repro_torch.train.optimizer import layer_stacks  # noqa: E402
from repro_torch.tree import leaves, leaves_with_path, path_str  # noqa: E402
from torch_fsdp import OPTS, pg_worker  # noqa: E402
from torch_fsdp import batch as _batch  # noqa: E402
from torch_fsdp import sharded as _sharded  # noqa: E402
from torch_fsdp import tcfg as _tcfg  # noqa: E402
from torch_parity import params_to_jax  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MESHES = (((2, 4), ("data", "model")), ((2, 4, 8), ("pod", "data", "model")))


# ------------------------------------------------------------ placements
def _jax_path(path) -> str:
    return "/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                    for e in path)


def _port_tree(jshapes, cfg):
    """The port's parameter tree as meta tensors, from the JAX tree's
    shapes (a stacked group's leaves unstacked into per-layer dicts)."""
    groups = [(name + "/", key, idx) for name, key, idx in layer_stacks(cfg)]
    out, origin = {}, {}
    for jpath, leaf in jax.tree_util.tree_flatten_with_path(jshapes)[0]:
        ps = _jax_path(jpath)
        hit = next(((g, key, idx) for g, key, idx in groups
                    if ps.startswith(g)), None)
        if hit is None:
            places = [(tuple(ps.split("/")), tuple(leaf.shape))]
        else:
            g, key, idx = hit
            sub = tuple(ps[len(g):].split("/"))
            places = [((key, i) + sub, tuple(leaf.shape[1:])) for i in idx]
        for path, shape in places:
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = torch.empty(shape, dtype=torch.float32,
                                         device="meta")
            origin[path] = (ps, hit is not None)
    return out, origin


def _check_placements(arch, full):
    jcfg = (jget_arch if full else jget_reduced)(arch)
    cfg = (configs.get_arch if full else configs.get_reduced)(arch)
    jshapes = jax.eval_shape(lambda: jinit_params(
        jcfg, jax.random.PRNGKey(0), JOptions(dtype=jnp.float32)))
    tree, origin = _port_tree(jshapes, cfg)
    n = 0
    for shape, names in MESHES:
        jmesh = AbstractMesh(shape, names)
        mesh = Mesh(["cpu"] * int(np.prod(shape)), shape, names)
        for mode in ("train", "serve"):
            for kw in (dict(), dict(kv_heads_divide=False),
                       dict(fsdp_over_pod=True)):
                want = {_jax_path(p): tuple(s) for p, s in
                        jax.tree_util.tree_flatten_with_path(
                            jparam_pspecs(jshapes, jmesh, mode=mode, **kw),
                            is_leaf=lambda x: isinstance(
                                x, jax.sharding.PartitionSpec))[0]}
                got = param_pspecs(tree, mesh, mode=mode, cfg=cfg, **kw)
                for path, leaf in leaves_with_path(tree):
                    node = got
                    for k in path:
                        node = node[k]
                    ps, stacked = origin[path]
                    w = want[ps][1:] if stacked else want[ps]
                    assert node == w, (arch, full, shape, mode, kw,
                                       path_str(path), node, w)
                    n += 1
    return n


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placements_match_jax(arch):
    assert _check_placements(arch, full=False) > 0
    assert _check_placements(arch, full=True) > 0


def test_c21_one_axis_mesh():
    """ROADMAP C21: the JAX layout raises on the JAX launcher's 1-axis
    host mesh; the port places the kv projections whole there."""
    cfg = configs.get_reduced("llama3.2-3b")
    jshapes = jax.eval_shape(lambda: jinit_params(
        jget_reduced("llama3.2-3b"), jax.random.PRNGKey(0),
        JOptions(dtype=jnp.float32)))
    with pytest.raises(KeyError, match="model"):
        jparam_pspecs(jshapes, AbstractMesh((2,), ("data",)))
    p = init_params(cfg, torch.Generator().manual_seed(0), OPTS,
                    device="cpu")
    specs = param_pspecs(p, make_mesh((2,), ("data",),
                                      devices=["cpu"] * 2), cfg=cfg)
    assert specs["layers"][0]["attn"]["k"]["w"] == ("data", None)
    assert specs["layers"][0]["attn"]["q"]["w"] == ("data", None)
    assert specs["embed"] == (None, "data")


def test_mesh_three_axes_and_slices_cover_leaves():
    """A 3-axis mesh's row-major coordinates; ``param_shardings`` parts
    tile every leaf exactly once across the shards of each replica."""
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"),
                     devices=["cpu"] * 4)
    assert [mesh.coords(j) for j in range(4)] == [
        {"pod": a, "data": b, "model": 0} for a in (0, 1) for b in (0, 1)]
    with pytest.raises(ValueError, match="1 to 3"):
        Mesh(["cpu"] * 16, (2, 2, 2, 2), ("a", "b", "c", "d"))
    cfg = configs.get_reduced("deepseek-v2-lite-16b")
    p = init_params(cfg, torch.Generator().manual_seed(0), OPTS,
                    device="cpu")
    specs = param_pspecs(p, mesh, cfg=cfg, fsdp_over_pod=True)
    parts = param_shardings(p, mesh, cfg=cfg, fsdp_over_pod=True)
    for (path, x), *mine in zip(leaves_with_path(p), *map(leaves, parts)):
        spec = specs
        for k in path:
            spec = spec[k]
        hit = torch.zeros(x.shape, dtype=torch.int32)
        for j, part in enumerate(mine):
            sl = local_slices(x.shape, spec, mesh, j)
            assert torch.equal(part, x[sl]), path_str(path)
            hit[sl] += 1
        assert bool((hit == hit.flatten()[0]).all()), path_str(path)


# ------------------------------------------------------------ the step
def _one_device(cfg, opt, steps):
    p = init_params(cfg, torch.Generator().manual_seed(0), OPTS,
                    device="cpu")
    init, step = make_train_step(cfg, _tcfg(opt), OPTS)
    s, ms = init(p), []
    for i in range(steps):
        p, s, m = step(p, s, _batch(cfg, i))
        ms.append(m)
    return p, ms


def _assert_close(got, want, what):
    for (path, a), b in zip(leaves_with_path(got), leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6,
                                   rtol=1e-5, err_msg=f"{what} "
                                   f"{path_str(path)}")


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("n", [2, 4])
def test_fsdp_step_matches_one_device(opt, n):
    cfg = configs.get_reduced("llama3.2-3b")
    want, wm = _one_device(cfg, opt, 2)
    tr, local, states, ms = _sharded(cfg, opt, n, 2)
    for m, w in zip(ms, wm):
        np.testing.assert_allclose(float(m["loss"]), float(w["loss"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(w["grad_norm"]), rtol=1e-5)
    _assert_close(tr.gather(local)[0], want, f"{opt} {n} shards")
    # each shard holds 1/n of every leaf the layout splits
    specs, whole = tr.specs, tr.gather(local, first=True)[0]
    for path, x in leaves_with_path(local[0]):
        spec, full = specs, whole
        for k in path:
            spec, full = spec[k], full[k]
        split = "data" in spec
        assert x.numel() * (n if split else 1) == full.numel()
    if opt == "adamw":
        assert states[0]["mu"]["embed"].shape == local[0]["embed"].shape


@pytest.mark.parametrize("world", [2, 4])
def test_group_comm_matches_local_comm(tmp_path, world):
    import torch.multiprocessing as mp
    out_path = str(tmp_path / "pg")
    ctx = mp.start_processes(pg_worker, args=(world, str(tmp_path / "fs"),
                                              out_path),
                             nprocs=world, join=False, start_method="spawn")
    t0 = time.monotonic()
    while not ctx.join(timeout=5):
        if time.monotonic() - t0 > 240.0:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {world}-process group did not finish")
    cfg = configs.get_reduced("llama3.2-3b")
    for opt in ("adamw", "adafactor"):
        _, local, _, ms = _sharded(cfg, opt, world, 2)
        for rank in range(world):
            got = np.load(f"{out_path}.{rank}.npz")
            assert np.array_equal(got[f"{opt}/loss"], np.array(
                [float(m["loss"]) for m in ms]))
            for path, x in leaves_with_path(local[rank]):
                assert np.array_equal(got[f"{opt}/{path_str(path)}"],
                                      x.numpy()), (opt, rank, path)


_JAX_SCRIPT = """
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_reduced
    from repro.core.jax_compat import make_mesh
    from repro.data import DataConfig, synthetic_lm_batch
    from repro.distributed.sharding import axis_rules, param_shardings
    from repro.models import ModelOptions, init_params
    from repro.train import OptConfig, TrainConfig, make_train_step

    cfg = get_reduced("llama3.2-3b")
    opts = ModelOptions(dtype=jnp.float32, remat=False, max_abs_pos=4096)
    mesh = make_mesh((2, 1), ("data", "model"))
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=10,
                                     decay_steps=3))
    opt_init, step_fn = make_train_step(cfg, tcfg, opts)
    losses, norms = [], []
    # the weights the test made (the JAX tree's leaves in order)
    z = np.load(sys.argv[1])
    tree = jax.tree_util.tree_structure(jax.eval_shape(
        lambda k: init_params(cfg, k, opts), jax.random.PRNGKey(0)))
    with mesh, axis_rules(mesh):
        params = jax.tree_util.tree_unflatten(
            tree, [jnp.asarray(z[f"arr_{i}"]) for i in range(len(z.files))])
        params = jax.device_put(params, param_shardings(params, mesh))
        opt = opt_init(params)
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
        jstep = jax.jit(step_fn, donate_argnums=(0, 1))
        for i in range(3):
            batch = {k: jnp.asarray(v)
                     for k, v in synthetic_lm_batch(dcfg, i).items()}
            params, opt, m = jstep(params, opt, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    print(json.dumps({"loss": losses, "grad_norm": norms,
                      "devices": len(jax.devices())}))
"""


@pytest.fixture(scope="module", autouse=True)
def jax_two_shard_run(tmp_path_factory):
    """The JAX step's subprocess (``_JAX_SCRIPT``), started with the
    module's first test so that its imports and compiles (~15 s) overlap
    the other tests; ``test_jax_two_shard_step_matches_port`` reads it.
    The weights are the port's ``init_params``, carried into the JAX
    layout and passed through a file."""
    d = tmp_path_factory.mktemp("jax_step")
    cfg = configs.get_reduced("llama3.2-3b")
    p = init_params(cfg, torch.Generator().manual_seed(0), OPTS,
                    device="cpu")
    np.savez(d / "params.npz",
             *jax.tree_util.tree_leaves(params_to_jax(p, cfg)))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    with open(d / "out.txt", "w") as out, open(d / "err.txt", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT),
             str(d / "params.npz")], env=env, stdout=out, stderr=err,
            text=True)
    run = dict(proc=proc, dir=d, params=p)
    yield run
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def test_jax_two_shard_step_matches_port(jax_two_shard_run):
    run = jax_two_shard_run
    rc = run["proc"].wait(timeout=400)
    assert rc == 0, (run["dir"] / "err.txt").read_text()[-3000:]
    import json
    ref = json.loads((run["dir"] / "out.txt").read_text().strip()
                     .splitlines()[-1])
    assert ref["devices"] == 2
    cfg = configs.get_reduced("llama3.2-3b")
    mesh = make_mesh((2, 1), ("data", "model"), devices=["cpu"] * 2)
    tr = FSDPTrainer(cfg, TrainConfig(opt=OptConfig(
        lr=1e-3, warmup_steps=10, decay_steps=3)), OPTS, mesh)
    local, states = tr.init(run["params"])
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    for i in range(3):
        batch = {k: torch.as_tensor(v)
                 for k, v in synthetic_lm_batch(dcfg, i).items()}
        local, states, m = tr.step(local, states, batch)
        np.testing.assert_allclose(float(m["loss"]), ref["loss"][i],
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   ref["grad_norm"][i], rtol=1e-5)


def test_restart_from_two_shards_onto_one_and_four(tmp_path):
    cfg = configs.get_reduced("llama3.2-3b")
    tr, local, states, _ = _sharded(cfg, "adamw", 2, 2)
    tr.save(str(tmp_path), 2, local, states)
    saved_p = tr.gather(local)[0]
    saved_o = tr.gather(states, tr.state_specs(states))[0]
    nxt = _batch(cfg, 2)
    want_local, _, want_m = tr.step(local, states, nxt)
    want = tr.gather(want_local)[0]
    # onto one device: the single-device layout
    p1 = init_params(cfg, torch.Generator().manual_seed(1), OPTS,
                     device="cpu")
    init, step = make_train_step(cfg, _tcfg("adamw"), OPTS)
    got, at = checkpoint.restore(str(tmp_path), {"params": p1,
                                                 "opt": init(p1)})
    assert at == 2
    for a, b in zip(leaves(got["params"]), leaves(saved_p)):
        assert torch.equal(a, b)
    for a, b in zip(leaves(got["opt"]), leaves(saved_o)):
        assert torch.equal(a, b)
    p1, _, m1 = step(got["params"], got["opt"], nxt)
    np.testing.assert_allclose(float(m1["loss"]), float(want_m["loss"]),
                               rtol=1e-6)
    _assert_close(p1, want, "restored onto 1")
    # onto four shards
    tr4, local4, states4, _ = _sharded(cfg, "adamw", 4, 0)
    local4, states4, at = tr4.restore(str(tmp_path), local4, states4)
    assert at == 2
    for a, b in zip(leaves(tr4.gather(local4)[0]), leaves(saved_p)):
        assert torch.equal(a, b)
    local4, _, m4 = tr4.step(local4, states4, nxt)
    np.testing.assert_allclose(float(m4["loss"]), float(want_m["loss"]),
                               rtol=1e-6)
    _assert_close(tr4.gather(local4)[0], want, "restored onto 4")
