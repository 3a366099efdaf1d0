"""The tensor-parallel drive shared by ``tests/test_torch_tensor_parallel.py``
and the gloo process group's workers it spawns. It imports no JAX, so
that a spawned worker starts in the time ``torch`` and the port take to
import."""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

from repro_torch import configs
from repro_torch.distributed import GroupComm, make_mesh
from repro_torch.distributed.tensor_parallel import (gather_vocab,
                                                     shard_params_tp)
from repro_torch.models import (ModelOptions, append_readonly, forward,
                                init_cache, init_params)

OPTS = ModelOptions(dtype=torch.float32)
PROMPT, STEPS, CACHE = 8, 3, 16
ROOT = Path(__file__).resolve().parent.parent


def tokens(cfg, seed=1):
    """Two rows of ``PROMPT + STEPS`` seeded ids."""
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, (2, PROMPT + STEPS)))


def weights(cfg, seed=0):
    return init_params(cfg, torch.Generator().manual_seed(seed), OPTS,
                       device="cpu")


def run(params, cfg, toks, *, comm=None, readonly=False):
    """The prefill's logits at every position, then three decode steps'
    (each ``(B, T, V)`` float32 on the CPU), on one device or, with a
    model ``comm``, over the shards' trees ``params`` (the logits
    gathered). With ``readonly`` the decode steps take the read-only
    cache and ``append_readonly`` writes their pieces, a shard each."""
    opts = dataclasses.replace(OPTS, readonly_cache=readonly)
    cache = init_cache(cfg, toks.shape[0], CACHE, opts, device="cpu",
                       comm=comm)

    def whole(logits):
        return logits if comm is None else gather_vocab(comm, logits,
                                                        cfg.vocab)[0]

    with torch.no_grad():
        logits, cache = forward(params, cfg, toks[:, :PROMPT], cache=cache,
                                opts=opts, mode="prefill", comm=comm)
        outs = [whole(logits)]
        for s in range(PROMPT, PROMPT + STEPS):
            logits, new = forward(params, cfg, toks[:, s:s + 1], cache=cache,
                                  opts=opts, mode="decode", comm=comm)
            outs.append(whole(logits))
            if not readonly:
                cache = new
            elif comm is None:
                append_readonly(cache, new)
            else:
                for c, fresh in zip(cache, new):
                    append_readonly(c, fresh)
    return [x.cpu() for x in outs]


# ---- the JAX forward on forced ("data", "model") host meshes
# The JAX package's prefill and STEPS decode steps of each reduced arch in
# argv[7:], jitted with param_shardings(mode="serve") on a (1, t) mesh of
# 4 forced host devices, over the leaves in argv[1]; logits to argv[2].
JAX_SERVE = """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_reduced
    from repro.distributed.sharding import axis_rules, param_shardings
    from repro.models import ModelOptions, forward, init_cache, init_params

    t, prompt, steps, cache_len = (int(x) for x in sys.argv[3:7])
    z = np.load(sys.argv[1])
    opts = ModelOptions(dtype=jnp.float32, remat=False)
    out = {}
    for arch in sys.argv[7:]:
        cfg = get_reduced(arch)
        tree = jax.tree_util.tree_structure(jax.eval_shape(
            lambda k: init_params(cfg, k, opts), jax.random.PRNGKey(0)))
        n = tree.num_leaves
        leaves = [jnp.asarray(z[f"{arch}/{i}"]) for i in range(n)]
        toks = jnp.asarray(z[f"{arch}/tokens"])
        mesh = Mesh(np.asarray(jax.devices()[:t]).reshape(1, t),
                    ("data", "model"))
        with mesh, axis_rules(mesh):
            p = jax.tree_util.tree_unflatten(tree, leaves)
            p = jax.device_put(p, param_shardings(p, mesh, mode="serve"))
            pre = jax.jit(lambda p, x, c: forward(
                p, cfg, x, cache=c, opts=opts, mode="prefill"))
            dec = jax.jit(lambda p, x, c: forward(
                p, cfg, x, cache=c, opts=opts, mode="decode"))
            cache = init_cache(cfg, toks.shape[0], cache_len, opts)
            lg, cache = pre(p, toks[:, :prompt], cache)
            out[f"{arch}/{t}/0"] = np.asarray(lg)
            for s in range(steps):
                lg, cache = dec(p, toks[:, prompt + s:prompt + s + 1], cache)
                out[f"{arch}/{t}/{s + 1}"] = np.asarray(lg)
    np.savez(sys.argv[2], **out)
    print("devices", len(jax.devices()))
"""


def start_jax_serve(d, archs, flatten):
    """``JAX_SERVE`` over ``archs``' reduced configs (the port's
    ``weights`` carried across by ``torch_parity.params_to_jax`` and
    ``flatten``, the caller's ``jax.tree_util.tree_leaves``) in one
    subprocess an extent (2 and 4), started at once: ``{t: Popen}``,
    writing ``d / f"ref{t}.npz"``, ``out{t}.txt`` and ``err{t}.txt``."""
    from torch_parity import params_to_jax
    arrays = {}
    for arch in archs:
        cfg = configs.get_reduced(arch)
        for i, x in enumerate(flatten(params_to_jax(weights(cfg), cfg))):
            arrays[f"{arch}/{i}"] = x
        arrays[f"{arch}/tokens"] = tokens(cfg).numpy().astype(np.int32)
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    procs = {}
    for t in (2, 4):
        with open(d / f"out{t}.txt", "w") as out, \
                open(d / f"err{t}.txt", "w") as err:
            procs[t] = subprocess.Popen(
                [sys.executable, "-c", textwrap.dedent(JAX_SERVE),
                 str(d / "in.npz"), str(d / f"ref{t}.npz"), str(t),
                 str(PROMPT), str(STEPS), str(CACHE), *archs], env=env,
                stdout=out, stderr=err, text=True)
    return procs


def jax_serve_ref(procs, d, t):
    """Extent ``t``'s logits from :func:`start_jax_serve`, once its
    subprocess has ended with 4 forced devices."""
    rc = procs[t].wait(timeout=400)
    assert rc == 0, (d / f"err{t}.txt").read_text()[-3000:]
    assert (d / f"out{t}.txt").read_text().split() == ["devices", "4"]
    return np.load(d / f"ref{t}.npz")


def stop(procs):
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def pg_worker(rank, world, store_path, out_path):
    """One model shard of a gloo group (a ``(1, world)`` mesh cut along
    ``"model"`` with ``GroupComm.axis``): the reduced llama's run with
    each cache; the gathered logits to an npz."""
    import torch.distributed as dist
    torch.set_num_threads(1)            # as the test module's process
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        cfg = configs.get_reduced("llama3.2-3b")
        mesh = make_mesh((1, world), ("data", "model"),
                         devices=["cpu"] * world)
        comm = GroupComm(device="cpu", mesh=mesh).axis("model")
        shard = shard_params_tp(weights(cfg), cfg, mesh, shards=[rank])
        out = {}
        for readonly in (False, True):
            for i, x in enumerate(run(shard, cfg, tokens(cfg), comm=comm,
                                      readonly=readonly)):
                out[f"{readonly}/{i}"] = x.numpy()
        np.savez(f"{out_path}.{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


# ---- the 2-D train step (tests/test_torch_tp_train.py)
TRAIN_ARCHS = ("qwen3-14b", "granite-34b")   # q / k norms; one shared kv head


def train_2d(cfg, mesh, steps, comm=None):
    """``steps`` AdamW steps of ``FSDPTrainer`` over ``mesh`` (float32,
    no remat) from seeded weights on the FSDP test's batches: (trainer,
    local parameters, local states, metrics, each step's gradients of
    this process's shards before the reduce, computed beside the step at
    the parameters it starts from, and those parameters as whole
    trees)."""
    from repro_torch.train.fsdp import FSDPTrainer
    from torch_fsdp import OPTS as TRAIN_OPTS
    from torch_fsdp import batch, tcfg
    tr = FSDPTrainer(cfg, tcfg("adamw"), TRAIN_OPTS, mesh, comm)
    p = init_params(cfg, torch.Generator().manual_seed(0), TRAIN_OPTS,
                    device="cpu")
    local, states = tr.init(p)
    ms, raws, starts = [], [], []
    for i in range(steps):
        starts.append(tr.whole(local))
        raws.append([g for _, g in tr._grads(tr.gather(local),
                                             batch(cfg, i))])
        local, states, m = tr.step(local, states, batch(cfg, i))
        ms.append(m)
    return tr, local, states, ms, raws, starts


def tp_train_worker(rank, world, store_path, out_path):
    """One rank of a 2 × 2 ``("data", "model")`` gloo group
    (``GroupComm`` over the world with its mesh): two steps of the 2-D
    trainer for each of ``TRAIN_ARCHS``; its shard's first gradients,
    parameters after two steps and losses to an npz."""
    import torch.distributed as dist
    from repro_torch.tree import leaves_with_path, path_str
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
        out = {}
        for arch in TRAIN_ARCHS:
            cfg = configs.get_reduced(arch)
            _, local, _, ms, raws, _ = train_2d(
                cfg, mesh, 2, comm=GroupComm(device="cpu", mesh=mesh))
            for path, x in leaves_with_path(local[0]):
                out[f"{arch}/p/{path_str(path)}"] = x.numpy()
            for path, x in leaves_with_path(raws[0][0]):
                out[f"{arch}/g/{path_str(path)}"] = x.numpy()
            out[f"{arch}/loss"] = np.array([float(m["loss"]) for m in ms])
        np.savez(f"{out_path}.{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
