"""Tensor parallelism over ``"model"`` for serving the dense decoders
(``repro_torch.distributed.tensor_parallel``, ``models.forward(comm=)``,
``serve.BatchedServer(comm=)``, ``launch/serve.py --tp``) on the CPU.

* Each reduced dense config (llama3.2-3b, qwen3-14b, nemotron-4-15b,
  granite-34b; float32) at t = 2 and 4 model shards on ``["cpu"] * t``
  against the same weights on one device: the prefill's logits at every
  position and three decode steps' logits, gathered, within 1e-5 abs +
  1e-5 rel, with the written cache and with the read-only one; the
  greedy tokens of ``BatchedServer`` equal. At t = 2 every shard holds
  one of the two kv heads; at t = 4 two shards share each (granite's one
  kv head is on every shard at both).
* A vocabulary that neither 2 nor 4 divides (509): the embedding and
  the head stay whole on every shard, and the logits agree as above.
* The JAX ``forward`` jitted with ``param_shardings(mode="serve")`` on
  forced ``(1, 2)`` and ``(1, 4)`` ``("data", "model")`` host meshes over
  the same weights (``torch_parity.params_to_jax``): its prefill and
  three decode steps against the port's shards, within the same limit.
  The JAX side runs in two subprocesses (one an extent) with 4 forced
  host devices, started with the module's first test (~10 s each,
  beside the other tests).
* A 2-process gloo ``GroupComm`` cut along ``"model"`` with
  ``GroupComm.axis`` gives ``LocalComm``'s bits.
* ``tp_degree``: 8 for the four full configs (3, 5, 6 and 6 heads a
  shard), raising for the recurrent, audio and vision configs (the MoE
  and MLA ones serve split: ``tests/test_torch_tp_moe.py``);
  ``shard_config`` pins ``head_dim``; ``shard_params_tp``'s cut tiles
  every split leaf and gives each shard the kv head its q heads read;
  ``comm.axis`` groups; the launcher's ``--tp 2 --devices cpu,cpu``.

Tolerance: the shards' partial outputs of o and down, summed in shard
order, differ from one device's single product by a few float32 ulp of
the partials: ~3e-6 at most on these O(1)-to-O(10) logits. The module
takes ~21 s in one process on one intra-op thread (``one_thread``),
the JAX subprocesses beside the other tests and the gloo workers ~5 s
of it.
"""
import dataclasses
import functools
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.distributed import LocalComm, Mesh, make_mesh  # noqa: E402
from repro_torch.distributed.tensor_parallel import (  # noqa: E402
    shard_config, shard_params_tp, tp_degree, unsplit_blocks)
from repro_torch.serve import BatchedServer, ServeConfig  # noqa: E402
from repro_torch.tree import leaves_with_path, path_str  # noqa: E402
from torch_tp import (OPTS, jax_serve_ref, pg_worker, run,  # noqa: E402
                      start_jax_serve, stop, tokens, weights)

DENSE = ("llama3.2-3b", "qwen3-14b", "nemotron-4-15b", "granite-34b")
MOE = ("deepseek-v2-lite-16b", "arctic-480b")   # tests/test_torch_tp_moe.py
OTHERS = tuple(a for a in ARCH_IDS if a not in DENSE + MOE)
ATOL = RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's tensors are a few KiB: one intra-op thread computes
    them as fast, without the idle pool's spinning (~40 % of the
    module's CPU time beside the JAX subprocesses); restored after."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _replica(cfg, params, t):
    mesh = make_mesh((1, t), ("data", "model"), devices=["cpu"] * t)
    return shard_params_tp(params, cfg, mesh), LocalComm(mesh).axis("model")


@functools.lru_cache(maxsize=None)
def _one_device(arch, readonly=False):
    """The reduced ``arch``'s run on one device (``torch_tp.run``), shared
    by the tests of both extents."""
    cfg = configs.get_reduced(arch)
    return run(weights(cfg), cfg, tokens(cfg), readonly=readonly)


def _close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL, err_msg=f"{what} step {i}")


# ------------------------------------------------------- one device
@pytest.mark.parametrize("readonly", [False, True])
@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("arch", DENSE)
def test_replica_matches_one_device(arch, t, readonly):
    cfg = configs.get_reduced(arch)
    want = _one_device(arch, readonly)
    shards, comm = _replica(cfg, weights(cfg), t)
    got = run(shards, cfg, tokens(cfg), comm=comm, readonly=readonly)
    assert [g.shape for g in got] == [w.shape for w in want]
    _close(got, want, f"{arch} t={t} readonly={readonly}")


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("arch", DENSE)
def test_server_tokens_match_one_device(arch, t):
    """``BatchedServer`` over the replica: three ragged prompts, batch 2
    (two waves), four greedy tokens, the one-device server's tokens."""
    cfg = configs.get_reduced(arch)
    params = weights(cfg)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 9, 3)]
    want = BatchedServer(cfg, ServeConfig(batch=2), params, OPTS).generate(
        prompts, max_new_tokens=4)
    shards, comm = _replica(cfg, params, t)
    srv = BatchedServer(cfg, ServeConfig(batch=2), shards, OPTS, comm=comm)
    got = srv.generate(prompts, max_new_tokens=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("t", [2, 4])
def test_vocab_that_t_does_not_divide(t):
    """vocab 509: the embedding and the tied head whole on every shard
    (llama), the untied head whole (qwen3); logits as one device's."""
    for arch in ("llama3.2-3b", "qwen3-14b"):
        cfg = dataclasses.replace(configs.get_reduced(arch), vocab=509)
        params, toks = weights(cfg), tokens(cfg)
        shards, comm = _replica(cfg, params, t)
        for sh in shards:
            assert torch.equal(sh["embed"], params["embed"])
            if not cfg.tie_embeddings:
                assert torch.equal(sh["lm_head"], params["lm_head"])
        _close(run(shards, cfg, toks, comm=comm), run(params, cfg, toks),
               f"{arch} vocab 509 t={t}")


# ------------------------------------------------------- the cut
@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("arch", DENSE)
def test_cut_tiles_leaves_and_kv_heads(arch, t):
    """Every leaf whole or cut into t equal parts that tile it; the
    embedding's and head's rows / columns by vocabulary; each shard's k
    and v the kv heads its q heads read (q head i of the model reads kv
    head i // (h / kvh))."""
    cfg = configs.get_reduced(arch)
    params = weights(cfg)
    shards, _ = _replica(cfg, params, t)
    lcfg = shard_config(cfg, t)
    dh, group = cfg.dh, cfg.n_heads // cfg.n_kv_heads
    for path, x in leaves_with_path(params):
        name = path_str(path)
        parts = []
        for sh in shards:
            node = sh
            for k in path:
                node = node[k]
            parts.append(node)
        if name.endswith(("attn/k/w", "attn/v/w")):
            for m, part in enumerate(parts):
                first_q = m * lcfg.n_heads
                kv = range(first_q // group, first_q // group
                           + lcfg.n_kv_heads)
                assert torch.equal(part, x[:, kv.start * dh:kv.stop * dh])
            continue
        if all(p.shape == x.shape for p in parts):
            assert all(torch.equal(p, x) for p in parts), name
            assert "norm" in name, name
            continue
        dim = next(d for d in range(x.dim())
                   if parts[0].shape[d] != x.shape[d])
        assert torch.equal(torch.cat(parts, dim), x), name
    assert lcfg.dh == cfg.dh


def test_shard_config_pins_head_dim():
    """A reduced llama has no ``head_dim`` (d_model // n_heads = 16): a
    view with fewer heads would read 32 without the pin."""
    cfg = configs.get_reduced("llama3.2-3b")
    assert cfg.head_dim == 0
    assert dataclasses.replace(cfg, n_heads=2).dh == 32
    view = shard_config(cfg, 2)
    assert (view.n_heads, view.n_kv_heads, view.d_ff, view.dh) == \
        (2, 1, 96, 16)
    with pytest.raises(ValueError, match="does not split 3 ways"):
        shard_config(cfg, 3)


def test_tp_degree_of_the_full_configs():
    """The largest extent up to a node's 8 cards: 8 for all four, with 3
    (llama), 5 (qwen3), 6 (nemotron, granite) heads and one kv head a
    shard; granite's kv head replicated."""
    heads = {"llama3.2-3b": 3, "qwen3-14b": 5, "nemotron-4-15b": 6,
             "granite-34b": 6}
    for arch, h in heads.items():
        cfg = configs.get_arch(arch)
        assert tp_degree(cfg, 8) == 8 and not unsplit_blocks(cfg)
        view = shard_config(cfg, 8)
        assert (view.n_heads, view.n_kv_heads, view.dh) == (h, 1, cfg.dh)
        assert tp_degree(cfg, 16) == {"llama3.2-3b": 8, "qwen3-14b": 8,
                                      "nemotron-4-15b": 16,
                                      "granite-34b": 16}[arch]


@pytest.mark.parametrize("arch", OTHERS)
def test_tp_degree_refuses_unsplit_blocks(arch):
    """The recurrent kinds (recurrentgemma, xlstm), cross-attention
    (whisper) and the vision merge (qwen2-vl) are not split yet (ROADMAP
    A10c); MoE and MLA serve split (``tests/test_torch_tp_moe.py``)."""
    cfg = configs.get_reduced(arch)
    assert unsplit_blocks(cfg)
    with pytest.raises(ValueError, match="A10c"):
        tp_degree(cfg, 2)


def test_tp_degree_refuses_absolute_positions():
    """A dense decoder with learned absolute positions (whisper's kind)
    is refused: the tensor-parallel forward adds no position embedding,
    so it must not run such a model."""
    cfg = dataclasses.replace(configs.get_reduced("llama3.2-3b"),
                              rope="none", abs_pos=True)
    assert unsplit_blocks(cfg) == ["absolute position embeddings"]
    with pytest.raises(ValueError, match="A10c"):
        tp_degree(cfg, 2)


def test_comm_axis_groups():
    """``Mesh.axis_groups`` on a (2, 2) mesh: the shards that share every
    other coordinate, in axis order. ``LocalComm.axis`` over a (1, 2)
    mesh is the comm of its two shards; on the (2, 2) mesh, where the
    axis has two groups, it raises rather than pick one."""
    mesh = Mesh(["cpu"] * 4, (2, 2), ("data", "model"))
    assert mesh.axis_groups("model") == [[0, 1], [2, 3]]
    assert mesh.axis_groups("data") == [[0, 2], [1, 3]]
    with pytest.raises(ValueError, match="2 groups along 'model'"):
        LocalComm(mesh).axis("model")
    comm = LocalComm(Mesh(["cpu"] * 2, (1, 2), ("data", "model"))) \
        .axis("model")
    assert comm.n == 2 and comm.shards == [0, 1]
    assert comm.mesh.axis_names == ("model",)
    xs = [torch.tensor([1.0]), torch.tensor([2.0])]
    assert [float(x) for x in comm.psum(xs)] == [3.0, 3.0]
    with pytest.raises(ValueError, match="no axis"):
        mesh.axis_groups("pod")


def test_launcher_tp_on_the_cpu():
    """``launch/serve.py --tp 2 --devices cpu,cpu`` serves the one-device
    launcher's tokens; ``--devices`` without ``--tp`` is refused."""
    from repro_torch.launch import serve as launch_serve
    argv = ["--arch", "llama3.2-3b", "--reduced", "--requests", "3",
            "--new-tokens", "3"]
    want = launch_serve.main(argv + ["--device", "cpu"])
    got = launch_serve.main(argv + ["--tp", "2", "--devices", "cpu,cpu"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(SystemExit):
        launch_serve.main(argv + ["--devices", "cpu"])


def test_group_comm_matches_local_comm(tmp_path):
    import torch.multiprocessing as mp
    world = 2
    out_path = str(tmp_path / "tp")
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
    shards, comm = _replica(cfg, weights(cfg), world)
    for readonly in (False, True):
        want = run(shards, cfg, tokens(cfg), comm=comm, readonly=readonly)
        for rank in range(world):
            got = np.load(f"{out_path}.{rank}.npz")
            for i, w in enumerate(want):
                assert np.array_equal(got[f"{readonly}/{i}"], w.numpy()), \
                    (rank, readonly, i)


# ------------------------------------------------------- the JAX mesh
@pytest.fixture(scope="module", autouse=True)
def jax_mesh_run(tmp_path_factory):
    """The JAX forward on the forced meshes (``torch_tp.JAX_SERVE``): one
    subprocess an extent, both started with the module's first test so
    that their imports and compiles overlap each other and the other
    tests; the port's weights and tokens go through a file."""
    d = tmp_path_factory.mktemp("jax_tp")
    procs = start_jax_serve(d, DENSE, jax.tree_util.tree_leaves)
    yield dict(procs=procs, dir=d)
    stop(procs)


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("arch", DENSE)
def test_jax_mesh_matches_replica(jax_mesh_run, arch, t):
    ref = jax_serve_ref(jax_mesh_run["procs"], jax_mesh_run["dir"], t)
    cfg = configs.get_reduced(arch)
    shards, comm = _replica(cfg, weights(cfg), t)
    got = run(shards, cfg, tokens(cfg), comm=comm)
    _close(got, [ref[f"{arch}/{t}/{i}"] for i in range(len(got))],
           f"{arch} t={t} vs the JAX (1, {t}) mesh")
