"""Tensor parallelism over ``"model"`` for serving the MoE decoders
(``repro_torch.distributed.tensor_parallel``: experts split across the
model shards, MLA's heads split by head; ``models.moe`` routing on every
shard) on the CPU.

* The reduced deepseek-v2-lite-16b (MLA, 8 routed experts top-2, a
  shared expert, a leading dense layer) and arctic-480b (GQA 4 / 2, 8
  experts top-2 beside a dense residual), float32, at t = 2 and 4 model
  shards on ``["cpu"] * t`` against the same weights on one device: the
  prefill's logits at every position and three decode steps' logits,
  gathered, within 1e-5 abs + 1e-5 rel, with the written cache and with
  the read-only one; ``BatchedServer``'s greedy tokens equal.
* Routing (``models.moe.route_log``): every shard's (experts, slots,
  kept) of every routed block bitwise equal to the other shards' and to
  one device's, at the reduced configs' capacity (no drops) and at a
  capacity factor of 0.5, where the prefill and the decode steps drop
  choices (C18: which choices drop is part of the served function); the
  logits agree there too.
* The JAX ``forward`` jitted with ``param_shardings(mode="serve")`` on
  forced ``(1, 2)`` and ``(1, 4)`` ``("data", "model")`` host meshes over
  the same weights (``torch_parity.params_to_jax``; XLA places the
  experts on ``"model"`` and exchanges the tokens itself): its prefill and
  three decode steps against the port's shards, within the same limit.
  The JAX side runs in two subprocesses (one an extent) started with the
  module's first test, beside the other tests.
* ``tp_degree`` = 8 for both full configs (2 / 7 heads, 8 / 16 experts
  a shard); ``shard_params_tp``'s cut tiles each expert stack along E
  and each MLA leaf by head, and keeps the latent projections, the
  router and the norms whole; the launcher's ``--tp 2 --devices cpu,cpu``
  and its refusal of an extent that does not split the arch.
* Training over ``"model"`` still refuses both archs (ROADMAP A10e):
  ``FSDPTrainer`` on a model axis of 2, ``tp_degree(mode="train")`` and
  the dry run's train extent.
* The dry run's deepseek-v2-lite-16b × decode_32k cell at the full
  config: rank 0 of a TP replica over a model axis of 8, an all-reduce
  and no all-to-all, fitting the card.

Tolerance: the shards' partial outputs of o and of the FFN, summed in
shard order, differ from one device's single product by a few float32
ulp of the partials (~3e-6 at most on these logits). The module takes
~20 s in one process on one intra-op thread, ~4 s of it the dry-run
cell, the JAX subprocesses (~20 s each) beside the other tests.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.distributed import LocalComm, make_mesh  # noqa: E402
from repro_torch.distributed.tensor_parallel import (  # noqa: E402
    shard_config, shard_params_tp, tp_degree, unsplit_blocks)
from repro_torch.models import moe  # noqa: E402
from repro_torch.serve import BatchedServer, ServeConfig  # noqa: E402
from repro_torch.tree import leaves_with_path, path_str  # noqa: E402
from torch_tp import (OPTS, jax_serve_ref, run, start_jax_serve,  # noqa: E402
                      stop, tokens, weights)

MOE = ("deepseek-v2-lite-16b", "arctic-480b")
ATOL = RTOL = 1e-5
LOW_CAPACITY = 0.5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module's few-KiB tensors; restored
    after."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _config(arch, capacity=None):
    cfg = configs.get_reduced(arch)
    if capacity is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity))


def _replica(cfg, params, t):
    mesh = make_mesh((1, t), ("data", "model"), devices=["cpu"] * t)
    return shard_params_tp(params, cfg, mesh), LocalComm(mesh).axis("model")


def _routed(params, cfg, comm=None, readonly=False):
    """``torch_tp.run`` with the routing and the drops logged: (logits,
    route_log, drop_log)."""
    moe.route_log, moe.drop_log = [], []
    try:
        out = run(params, cfg, tokens(cfg), comm=comm, readonly=readonly)
        return out, moe.route_log, moe.drop_log
    finally:
        moe.route_log = moe.drop_log = None


@functools.lru_cache(maxsize=None)
def _one_device(arch, readonly=False, capacity=None):
    cfg = _config(arch, capacity)
    return _routed(weights(cfg), cfg, readonly=readonly)


def _close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL, err_msg=f"{what} step {i}")


# ------------------------------------------------------- one device
@pytest.mark.parametrize("readonly", [False, True])
@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("arch", MOE)
def test_replica_matches_one_device(arch, t, readonly):
    cfg = _config(arch)
    want = _one_device(arch, readonly)[0]
    shards, comm = _replica(cfg, weights(cfg), t)
    got = run(shards, cfg, tokens(cfg), comm=comm, readonly=readonly)
    assert [g.shape for g in got] == [w.shape for w in want]
    _close(got, want, f"{arch} t={t} readonly={readonly}")


@pytest.mark.parametrize("capacity", [None, LOW_CAPACITY])
@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("arch", MOE)
def test_routing_is_one_devices_on_every_shard(arch, t, capacity):
    """Each routed block's (experts, slots, kept) on every shard equal,
    bit for bit, to one device's — also where capacity drops choices,
    which at the low capacity happens in the prefill and in the decode
    steps (one device's ``drop_log``); the logits agree."""
    cfg = _config(arch, capacity)
    want, one_log, drops = _one_device(arch, capacity=capacity)
    shards, comm = _replica(cfg, weights(cfg), t)
    got, log, tp_drops = _routed(shards, cfg, comm)
    n_moe = sum(1 for lp in shards[0]["layers"] if "moe" in lp)
    assert len(one_log) == n_moe * (1 + len(want) - 1)
    assert len(log) == t * len(one_log) and tp_drops == drops
    for i, (_, *ref) in enumerate(one_log):
        blocks = log[i * t:(i + 1) * t]
        assert [b[0] for b in blocks] == list(range(t))
        for shard, *routing in blocks:
            for a, b, name in zip(routing, ref, ("experts", "slots", "kept")):
                assert torch.equal(a, b), (i, shard, name)
    dropped = [routed - kept for kept, routed in drops]
    if capacity is None:
        assert not any(dropped)
    else:
        assert dropped[0] > 0 and any(dropped[n_moe:]), dropped
    _close(got, want, f"{arch} t={t} capacity={capacity}")


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("arch", MOE)
def test_server_tokens_match_one_device(arch, t):
    """``BatchedServer`` over the replica: three ragged prompts, batch 2
    (two waves), four greedy tokens, the one-device server's tokens."""
    cfg = _config(arch)
    params = weights(cfg)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 9, 3)]
    want = BatchedServer(cfg, ServeConfig(batch=2), params, OPTS).generate(
        prompts, max_new_tokens=4)
    shards, comm = _replica(cfg, params, t)
    got = BatchedServer(cfg, ServeConfig(batch=2), shards, OPTS,
                        comm=comm).generate(prompts, max_new_tokens=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------- the cut
_WHOLE = ("attn/dkv/w", "attn/k_rope/w", "attn/kv_norm/scale",
          "moe/router/w")


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("arch", MOE)
def test_cut_tiles_experts_and_heads(arch, t):
    """Every leaf whole or cut into t equal parts that tile it: the
    expert stacks along E (shard m holds experts [m·E/t, (m+1)·E/t),
    as its config view says), MLA's q / uk / uv columns and o rows by
    whole heads, arctic's k / v the kv heads a shard's q heads read; MLA's
    latent projections, the router and the norms whole on every
    shard."""
    cfg = _config(arch)
    params = weights(cfg)
    shards, _ = _replica(cfg, params, t)
    view = shard_config(cfg, t)
    assert view.moe.n_experts == cfg.moe.n_experts
    e = cfg.moe.n_experts // t
    for path, x in leaves_with_path(params):
        name = path_str(path)
        parts = []
        for sh in shards:
            node = sh
            for k in path:
                node = node[k]
            parts.append(node)
        if name.endswith(("moe/up", "moe/gate", "moe/down")):
            for m, part in enumerate(parts):
                own = view.moe.experts_of(m)
                assert (own.start, own.stop) == (m * e, (m + 1) * e)
                assert torch.equal(part, x[own.start:own.stop]), name
            continue
        if cfg.mla is not None and name.endswith(("attn/q/w", "attn/uk/w",
                                                  "attn/uv/w", "attn/o/w")):
            dim = 0 if name.endswith("o/w") else 1
            heads = x.reshape(*x.shape[:dim], cfg.n_heads, -1,
                              *x.shape[dim + 1:])
            for m, part in enumerate(parts):
                own = heads.narrow(dim, m * view.n_heads, view.n_heads)
                assert torch.equal(part, own.reshape(part.shape)), name
            continue
        if name.endswith(("attn/k/w", "attn/v/w")):   # arctic's GQA
            group = cfg.n_heads // cfg.n_kv_heads
            for m, part in enumerate(parts):
                kv = m * view.n_heads // group * cfg.dh
                assert torch.equal(part, x[:, kv:kv + part.shape[1]]), name
            continue
        if all(p.shape == x.shape for p in parts):
            assert all(torch.equal(p, x) for p in parts), name
            assert "norm" in name or name.endswith(_WHOLE), name
            continue
        assert not name.endswith(_WHOLE), name
        dim = next(d for d in range(x.dim())
                   if parts[0].shape[d] != x.shape[d])
        assert torch.equal(torch.cat(parts, dim), x), name


def test_tp_degree_of_the_full_configs():
    """8 for both at a node's 8 cards: deepseek 2 heads (MLA's latent
    whole) and 8 of 64 experts a shard, arctic 7 / 1 heads and 16 of 128
    experts; the dense FFN widths cut 8 ways."""
    for arch, (h, kvh, e) in {"deepseek-v2-lite-16b": (2, 2, 8),
                              "arctic-480b": (7, 1, 16)}.items():
        cfg = configs.get_arch(arch)
        assert tp_degree(cfg, 8) == 8 and not unsplit_blocks(cfg)
        view = shard_config(cfg, 8)
        assert (view.n_heads, view.n_kv_heads) == (h, kvh)
        assert len(view.moe.experts_of(7)) == e
        assert view.moe.experts_of(7).stop == cfg.moe.n_experts
        assert (view.moe.n_experts, view.moe.expert_ff) == \
            (cfg.moe.n_experts, cfg.moe.expert_ff)
        assert view.moe.dense_residual_ff * 8 == cfg.moe.dense_residual_ff
        assert view.moe.first_dense_ff * 8 == cfg.moe.first_dense_ff
    with pytest.raises(ValueError, match="does not split 3 ways"):
        shard_config(configs.get_reduced("arctic-480b"), 3)


def test_launcher_tp_on_the_cpu():
    """``launch/serve.py --arch deepseek-v2-lite-16b --reduced --tp 2
    --devices cpu,cpu --retrieval`` serves the one-device launcher's
    tokens; ``--tp 3``, which does not split the arch, raises."""
    from repro_torch.launch import serve as launch_serve
    argv = ["--arch", "deepseek-v2-lite-16b", "--reduced", "--requests",
            "3", "--new-tokens", "3", "--retrieval"]
    want = launch_serve.main(argv + ["--device", "cpu"])
    got = launch_serve.main(argv + ["--tp", "2", "--devices", "cpu,cpu"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="does not split 3 ways"):
        launch_serve.main(argv + ["--tp", "3", "--devices", "cpu,cpu,cpu"])


# ------------------------------------------------------- training refuses
@pytest.mark.parametrize("arch", MOE)
def test_training_over_model_still_refuses(arch):
    """Training over ``"model"`` does not split experts or MLA yet
    (ROADMAP A10e): ``FSDPTrainer`` on a model axis of 2 raises, and so
    does ``tp_degree`` for training; the dry run keeps the train cell's
    model axis at 1 and says why."""
    from repro_torch.launch.mesh import model_extent
    from repro_torch.train.fsdp import FSDPTrainer
    from torch_fsdp import OPTS as TRAIN_OPTS
    from torch_fsdp import tcfg
    cfg = _config(arch)
    assert "MoE experts" in unsplit_blocks(cfg, "train")
    with pytest.raises(ValueError, match="A10e"):
        FSDPTrainer(cfg, tcfg("adamw"), TRAIN_OPTS,
                    make_mesh((1, 2), ("data", "model"),
                              devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="A10e"):
        tp_degree(cfg, 2, mode="train")
    t, why = model_extent(configs.get_arch(arch), "train")
    assert t == 1 and "A10e" in why and "FSDP" in why
    assert model_extent(configs.get_arch(arch), "decode")[0] == 8


def test_dry_run_decode_cell_over_model():
    """deepseek-v2-lite-16b × decode_32k at the full config: rank 0 of a
    TP replica on ``(32, 8)`` (2 heads, experts 0-7 of 64), its FFN's
    sums all-reduces over NVLink with no all-to-all, fitting the card."""
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell("deepseek-v2-lite-16b", "decode_32k",
                          multi_pod=False, verbose=False)
    assert rec["tensor_parallel"] and rec["mesh"] == "32x8"
    assert "experts 8 of 64" in rec["layout"]
    assert "experts 0-7 of 64" in rec["notes"]
    coll = rec["collectives"]
    assert coll["all-reduce"] > 0 and coll["all-to-all"] == 0
    assert coll["by_link"] == {"nvlink": coll["total"], "network": 0}
    assert rec["memory"]["fits_hbm"] and "no_fit_reason" not in rec


# ------------------------------------------------------- the JAX mesh
@pytest.fixture(scope="module", autouse=True)
def jax_mesh_run(tmp_path_factory):
    """The JAX forward of both reduced configs on the forced meshes
    (``torch_tp.JAX_SERVE``), one subprocess an extent, started with the
    module's first test."""
    d = tmp_path_factory.mktemp("jax_tp_moe")
    procs = start_jax_serve(d, MOE, jax.tree_util.tree_leaves)
    yield dict(procs=procs, dir=d)
    stop(procs)


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("arch", MOE)
def test_jax_mesh_matches_replica(jax_mesh_run, arch, t):
    ref = jax_serve_ref(jax_mesh_run["procs"], jax_mesh_run["dir"], t)
    cfg = _config(arch)
    shards, comm = _replica(cfg, weights(cfg), t)
    got = run(shards, cfg, tokens(cfg), comm=comm)
    _close(got, [ref[f"{arch}/{t}/{i}"] for i in range(len(got))],
           f"{arch} t={t} vs the JAX (1, {t}) mesh")
