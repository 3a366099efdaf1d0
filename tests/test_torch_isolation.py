"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, its entry points run on the card unless asked for the CPU, and
its mesh routes (ROADMAP Queue A5) run on shards simulated from an
explicit device list."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch as rt  # noqa: E402
from repro_torch.core import MegastepEngine, StreamJoinEngine  # noqa: E402
from repro_torch.kernels import assign as ka  # noqa: E402
from repro_torch.kernels import distance_topk as kg  # noqa: E402
from repro_torch.kernels import quant_topk as kq  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
EXAMPLES = ("quickstart", "outlier_detection", "forest_selfjoin",
            "distributed_join", "serve_retrieval", "train_lm")
EXAMPLE_FILES = [ROOT / "examples" / f"{name}_torch.py" for name in EXAMPLES]


def test_import_loads_neither_jax_nor_repro():
    code = (
        "import sys, repro_torch, repro_torch.core, repro_torch.kernels\n"
        "import repro_torch.serve.retrieval, repro_torch.core.segments\n"
        "import repro_torch.configs, repro_torch.models\n"
        "import repro_torch.serve.serve_step, repro_torch.launch.serve\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.serve.scheduler, repro_torch.launch.join\n"
        "import repro_torch.obs.export, repro_torch.data\n"
        "import repro_torch.distributed, repro_torch.core.sharded\n"
        "import repro_torch.core.distributed, repro_torch.quant.engine\n"
        "import repro_torch.models.moe, repro_torch.core.certify\n"
        "import repro_torch.models.recurrent\n"
        "import repro_torch.train, repro_torch.train.checkpoint\n"
        "import repro_torch.launch.train\n"
        "import repro_torch.distributed.tensor_parallel\n"
        "import repro_torch.train.fsdp, repro_torch.launch.dryrun\n"
        "import runpy\n"
        "runpy.run_path(sys.argv[1], run_name='tune_quant')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code,
                          str(ROOT / "tools" / "tune_quant.py")], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_sources_import_no_jax_or_repro():
    pat = re.compile(r"^\s*(import\s+(jax|jaxlib|repro)\b(?!_torch)"
                     r"|from\s+(jax|jaxlib|repro)\b(?!_torch))", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + \
        sorted((ROOT / "tools").glob("*.py")) + EXAMPLE_FILES
    assert len(files) >= 15
    for name in ("models/moe.py", "core/certify.py", "models/recurrent.py",
                 "train/optimizer.py", "train/train_step.py",
                 "train/checkpoint.py", "tree.py", "launch/train.py",
                 "data.py", "distributed/tensor_parallel.py",
                 "train/fsdp.py", "distributed/mesh.py"):
        assert PKG / name in files
    assert ROOT / "tools" / "tune_quant.py" in files
    assert ROOT / "tools" / "tp_train_bf16_gap.py" in files
    offenders = [str(p.relative_to(ROOT)) for p in files
                 if pat.search(p.read_text())]
    assert not offenders, offenders


def test_examples_load_neither_jax_nor_repro():
    """The port's six examples import torch, numpy and the port only:
    loading all six (their imports, not their ``main``) leaves no JAX
    module and no module of the JAX package behind."""
    code = (
        "import runpy, sys\n"
        "for path in sys.argv[1:]:\n"
        "    assert callable(runpy.run_path(path, run_name='example')"
        "['main'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    assert all(p.is_file() for p in EXAMPLE_FILES)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code]
                         + [str(p) for p in EXAMPLE_FILES], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_main_needs_a_card(monkeypatch, name):
    """Each example's ``main([])`` takes the card; without one it raises
    before any work, never carrying on on the CPU."""
    import runpy
    main = runpy.run_path(str(ROOT / "examples" / f"{name}_torch.py"),
                          run_name="example")["main"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([])


def test_dry_run_needs_no_card(monkeypatch):
    """The dry run (``launch.dryrun``) is the one entry point that asks
    for no card: with no CUDA device, reduced cells of each kind and one
    full-size cell trace,
    its tensors meta tensors (and the CPU's fake ones its parameters are
    shaped from), and no operator makes a CUDA tensor."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import cost, dryrun, specs
    from repro_torch.launch.mesh import AbstractMesh

    seen = set()

    class Devices(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (list, tuple)) else [out]):
                if isinstance(t, torch.Tensor):
                    seen.add(t.device.type)
            return out

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arch = configs.get_reduced("llama3.2-3b")
    mesh = AbstractMesh((4,), ("data",))
    with Devices():
        for cell in (specs.build_cell(arch, "prefill_32k", mesh),
                     specs.build_cell(arch, "decode_32k", mesh),
                     specs.build_train_cell(arch, ShapeConfig(
                         "tiny_train", 32, 8, "train"), mesh)):
            got = cost.trace_step(cell.step_fn, cell.abstract_args,
                                  comm=cell.comm)[1]
            assert got.flops > 0 and got.peak_bytes > 0
        rec = dryrun.run_cell("llama3.2-3b", "decode_32k", multi_pod=False,
                              verbose=False)
        assert rec["memory"]["peak_bytes"] > 0
    assert "meta" in seen and "cuda" not in seen, seen


def _small():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(300, 4)).astype(np.float32),
            rng.normal(size=(40, 4)).astype(np.float32))


@pytest.mark.parametrize("entry", [
    "build_index", "knn_join_batched", "MegastepEngine", "StreamJoinEngine",
    "sindex_from_arrays", "brute_force_knn", "knn_join",
    "QuantMegastepEngine", "MutableIndex", "Datastore", "init_params",
    "init_cache", "params_from_jax", "BatchedServer", "launch.serve",
    "hbrj_join", "pbj_join", "select_pivots", "launch.join", "make_mesh",
    "GroupComm", "distributed_knn_join", "distributed_phase1",
    "ShardedMegastepEngine", "ShardedQuantMegastepEngine",
    "sharded Datastore", "launch.join --distributed", "tools/tune_quant.py",
    "init_params moe", "init_cache moe", "init_params hybrid",
    "init_cache ssm", "launch.train", "opt_state_from_jax",
    "launch.serve --tp", "launch.serve --tp moe", "launch.train --tp"])
def test_entry_points_default_to_cuda(monkeypatch, entry):
    """Without a card, an entry point called without device="cpu" raises;
    it never carries on silently on the CPU."""
    s, r = _small()
    cfg = rt.JoinConfig(k=3, n_pivots=8, tile_r=16, tile_s=32)
    idx = rt.build_index(s, cfg, device="cpu")
    from repro_torch import configs, models, serve
    from repro_torch.launch import join as launch_join
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    lm = configs.get_reduced("llama3.2-3b")
    moe_lm = configs.get_reduced("deepseek-v2-lite-16b")
    import runpy
    tune = runpy.run_path(str(ROOT / "tools" / "tune_quant.py"),
                          run_name="tune_quant")
    cpu_params = models.init_params(lm, torch.Generator(), device="cpu")
    np_params = {"embed": cpu_params["embed"].float().numpy(),
                 "final_norm": {"scale": np.ones(lm.d_model, np.float32)},
                 "groups": []}
    from repro_torch.core.distributed import (distributed_knn_join,
                                              distributed_phase1)
    from repro_torch.core.sharded import ShardedMegastepEngine
    from repro_torch.distributed import GroupComm, make_mesh
    from repro_torch.quant.engine import ShardedQuantMegastepEngine
    idx_q = rt.build_index(s, cfg, quantize="int8", device="cpu")
    plan = rt.core.plan_join(r, s, dataclasses.replace(cfg, n_groups=2),
                             device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "build_index": lambda: rt.build_index(s, cfg),
        "knn_join_batched": lambda: rt.knn_join_batched(r, s, config=cfg),
        "MegastepEngine": lambda: MegastepEngine(idx, cfg),
        "StreamJoinEngine": lambda: StreamJoinEngine(idx, cfg),
        "sindex_from_arrays": lambda: rt.sindex_from_arrays(
            {}, cfg),
        "brute_force_knn": lambda: rt.brute_force_knn(r, s, 3),
        "knn_join": lambda: rt.knn_join(r, s, config=cfg),
        "QuantMegastepEngine": lambda: rt.QuantMegastepEngine(idx, cfg),
        "MutableIndex": lambda: rt.MutableIndex.build(s, cfg),
        "Datastore": lambda: rt.serve.Datastore.build(s, np.zeros(300),
                                                      k=3, n_pivots=8),
        "init_params": lambda: models.init_params(lm, torch.Generator()),
        "init_cache": lambda: models.init_cache(lm, 2, 8),
        "params_from_jax": lambda: models.params_from_jax(np_params, lm),
        # the server runs where its parameters live: they come from the
        # card unless made with device="cpu"
        "BatchedServer": lambda: serve.BatchedServer(
            lm, serve.ServeConfig(), models.init_params(
                lm, torch.Generator())),
        "launch.serve": lambda: launch_serve.main(
            ["--arch", "llama3.2-3b", "--reduced"]),
        "hbrj_join": lambda: rt.hbrj_join(r, s, 3, n_reducers=4),
        "pbj_join": lambda: rt.pbj_join(r, s, 3, cfg, n_reducers=4),
        "select_pivots": lambda: rt.core.select_pivots(s, 8),
        "launch.join": lambda: launch_join.main(["--n", "200", "--k", "3"]),
        # a mesh takes the present cards unless given an explicit list
        "make_mesh": lambda: make_mesh((2,), ("shard",)),
        "GroupComm": lambda: GroupComm(),
        "distributed_knn_join": lambda: distributed_knn_join(
            r, s, plan, make_mesh((2,), ("data",)), reducer="shuffle"),
        "distributed_phase1": lambda: distributed_phase1(
            s, plan.index.pivots, make_mesh((2,), ("data",))),
        "ShardedMegastepEngine": lambda: ShardedMegastepEngine(
            idx, cfg, n_shards=2),
        "ShardedQuantMegastepEngine": lambda: ShardedQuantMegastepEngine(
            idx_q, cfg, n_shards=2),
        "sharded Datastore": lambda: rt.serve.Datastore.build(
            s, np.zeros(300), k=3, n_pivots=8, n_shards=2, replication=2),
        "launch.join --distributed": lambda: launch_join.main(
            ["--n", "200", "--k", "3", "--distributed", "--shards", "2",
             "--simulate"]),
        "tools/tune_quant.py": lambda: tune["main"](["--fast"]),
        "init_params moe": lambda: models.init_params(moe_lm,
                                                      torch.Generator()),
        "init_cache moe": lambda: models.init_cache(moe_lm, 2, 8),
        "init_params hybrid": lambda: models.init_params(
            configs.get_reduced("recurrentgemma-9b"), torch.Generator()),
        "init_cache ssm": lambda: models.init_cache(
            configs.get_reduced("xlstm-350m"), 2, 8),
        "launch.train": lambda: launch_train.main(
            ["--arch", "llama3.2-3b", "--reduced", "--steps", "1"]),
        "opt_state_from_jax": lambda: models.opt_state_from_jax(
            {"step": np.int32(0), "mu": np_params, "nu": np_params,
             "master": np_params}, lm),
        # a tensor-parallel replica takes the present cards unless given
        # its shards' devices
        "launch.serve --tp": lambda: launch_serve.main(
            ["--arch", "llama3.2-3b", "--reduced", "--tp", "2"]),
        "launch.serve --tp moe": lambda: launch_serve.main(
            ["--arch", "deepseek-v2-lite-16b", "--reduced", "--tp", "2"]),
        "launch.train --tp": lambda: launch_train.main(
            ["--arch", "llama3.2-3b", "--reduced", "--steps", "1",
             "--tp", "2", "--shards", "2"]),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


@pytest.mark.parametrize("route", [
    "sharded stream", "sharded batched", "sharded datastore",
    "datastore recover_shards", "nbytes per shard", "launch.join mesh"])
def test_mesh_routes_run(route):
    """The mesh routes (ROADMAP Queue A5) run, on shards simulated from an
    explicit CPU device list, with the single-device distances."""
    from repro_torch.distributed import make_mesh
    from repro_torch.launch import join as launch_join
    from repro_torch.serve import Datastore
    s, r = _small()
    cfg = rt.JoinConfig(k=3, n_pivots=8, tile_r=16, tile_s=32)
    idx = rt.build_index(s, cfg, device="cpu")
    values = np.arange(s.shape[0]) % 5
    mesh = make_mesh((2,), ("shard",), devices=["cpu", "cpu"])
    d0, _ = MegastepEngine(idx, cfg, device="cpu").join_batch(r)
    store = Datastore.build(s, values, k=3, n_pivots=8, n_shards=2,
                            mesh=mesh, device="cpu")
    calls = {
        "sharded stream": lambda: StreamJoinEngine(
            idx, cfg, megastep=True, mesh=mesh,
            device="cpu").join_batch(r)[0],
        "sharded batched": lambda: rt.knn_join_batched(
            r, index=idx, mesh=mesh, megastep=True, device="cpu").distances,
        "sharded datastore": lambda: store.retrieve(r)[0],
        "datastore recover_shards": lambda: (
            store.retrieve(r), store.recover_shards(wait=True))[0][0],
        "nbytes per shard": lambda: idx.nbytes_resident(n_shards=2),
        "launch.join mesh": lambda: launch_join.main(
            ["--n", "300", "--k", "3", "--pivots", "8", "--device", "cpu",
             "--distributed", "--shards", "2", "--simulate"]),
    }
    got = calls[route]()
    if route == "nbytes per shard":
        assert 0 < got < idx.nbytes_resident()
    elif route == "launch.join mesh":
        assert got.distances.shape == (300, 3)
    else:
        assert np.array_equal(got, d0)


@pytest.mark.parametrize("field,bad,message", [
    ("n_groups", None, None), ("grouping", "spectral", "unknown grouping"),
    ("use_tile_pruning", None, None), ("reducer", "tree", "unknown reducer"),
    ("quant_slack", -2, "quant_slack must be")])
def test_config_validates_restored_fields(field, bad, message):
    """The §5 grouping, reducer and shortlist knobs take the JAX
    package's defaults and are validated as it validates them (None:
    neither package validates the field)."""
    from repro.core import JoinConfig as JConfig
    assert getattr(rt.JoinConfig(), field) == getattr(JConfig(), field)
    for cls in (rt.JoinConfig, JConfig):
        if bad is not None:
            with pytest.raises(ValueError, match=message):
                cls(**{field: bad})
    cfg = rt.JoinConfig(reducer="auto", use_tile_pruning=False)
    assert cfg.resolved_reducer == JConfig(
        reducer="auto", use_tile_pruning=False).resolved_reducer == "dense"


def test_kernel_wrappers_take_no_cpu_tensor():
    """The CUDA wrappers launch their kernel or raise: a CPU tensor is
    refused, not routed to the plain version."""
    s, r = _small()
    with pytest.raises(ValueError, match="CUDA"):
        ka.assign_cuda(torch.from_numpy(r), torch.from_numpy(s[:8]))
    sched = torch.zeros((3, 1), dtype=torch.int32)
    cnt = torch.ones((3,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kg.distance_topk_gather_cuda(torch.from_numpy(r),
                                     torch.from_numpy(s), 4, sched, cnt,
                                     bm=16, bn=32)
    qi = torch.zeros((40, 4), dtype=torch.int8)
    v = torch.ones((40,))
    si = torch.zeros((64, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        kg.distance_topk_cuda(torch.from_numpy(r), torch.from_numpy(s), 4)
    with pytest.raises(ValueError, match="CUDA"):
        kq.quant_coarse_gather_cuda(
            qi, v, v, v, si, torch.ones((2,)),
            torch.zeros((64,), dtype=torch.float16), torch.ones((64,)), 16,
            sched, cnt, bm=16, bn=32)
    from repro_torch.kernels import flash_attention as kf
    q = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        kf.flash_attention_cuda(q, q, q)


def test_train_launcher_tp_runs_on_the_cpu_when_asked():
    """``launch.train --tp 2 --shards 2 --devices cpu,cpu,cpu,cpu`` trains
    over a (2, 2) ``("data", "model")`` mesh on the CPU: its losses are
    one device's within 1e-6 rel (the CPU draw of the same seed)."""
    from repro_torch.launch import train as launch_train
    argv = ["--arch", "llama3.2-3b", "--reduced", "--steps", "3", "--seq",
            "32", "--batch", "4"]
    want = launch_train.main(argv + ["--device", "cpu"])
    got = launch_train.main(argv + ["--tp", "2", "--shards", "2",
                                    "--devices", "cpu,cpu,cpu,cpu"])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    assert len(got["resident_bytes"]) == 4
    with pytest.raises(SystemExit):
        launch_train.main(argv + ["--tp", "2", "--shards", "2",
                                  "--devices", "cpu,cpu"])
