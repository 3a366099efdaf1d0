"""The port's dry run (``repro_torch.launch``: ``mesh``, ``cost``,
``specs``, ``dryrun``) and K-F / K-B as ``torch.library`` operators, on
the CPU.

* (a) Parity with the JAX dry run on the reduced llama and a tiny train
  shape over a ``("data", "model")`` mesh of shape (4, 1) — the JAX
  layout with no tensor parallelism (a mesh with a model axis avoids
  ROADMAP C21): the per-device argument bytes (parameters, AdamW state
  and batch) equal to the byte to JAX's
  ``memory_analysis().argument_size_in_bytes``, leaf by leaf (a JAX leaf
  stacked over a group's layers against the sum of the port's per-layer
  leaves); the port's flops outside attention (every operator but K-F's
  and K-B's) within 2 % of ``hlo_analysis.analyze``'s flops less the
  dots of JAX's ``_sdpa`` (``models/layers.py:130``), computed here as
  ``_sdpa`` makes them: every (query, key) pair, masked ones too, in the
  forward, its remat recompute and the backward's four products. The
  JAX side runs in one subprocess with 4 forced host devices, started
  with the module's first test (~15 s beside the others).
* (b) The recording comm's bytes by kind equal a sum over
  ``param_pspecs``' placements computed here.
* (c) Each operator's fake output has the plain version's shapes and
  dtypes; a real CPU call through each operator gives the plain
  version's bits (K-F with and without lse, with appended keys, capped;
  K-B); ``visible_pairs`` equals the count of the visibility mask; the
  dry run's flop count equals ``FlopCounterMode``'s over the same step.
* (d) One full-size cell, llama3.2-3b × decode_32k on the 256-card mesh,
  traces in seconds, and its ``fits_hbm`` follows from its bytes.
* (e) A dense decoder's serving cells on an ``AbstractMesh((4, 2),
  ("data", "model"))`` run rank 0's shard of the tensor-parallel forward:
  the recording comm's all-reduce bytes are two psums of ``(b, T,
  d_model)`` a layer plus the embedding's, its all-gather bytes the
  served position's logits, and the arguments rank 0's cut of the
  weights (and cache); a non-dense arch's cells keep the data-parallel
  layout, and the record says why.
* (f) A dense decoder's train cell on a ``("data", "model")`` mesh runs
  rank 0 of FSDP × TP (``train.fsdp``): on the reduced llama over
  ``(16, 2)`` (32 ranks, four nodes) the model axis's all-reduces are
  recorded over NVLink and the data axis's gather and reduce-scatter
  over the network, the arguments rank 0's parts; the four dense
  decoders' train_4k cells on ``(32, 8)`` and ``(2, 32, 8)`` are built
  as rank 0 of a TP replica (its model shard's heads, cut again over
  ``"data"``); granite-34b × train_4k on ``(32, 8)``, traced in full
  (~50 s), fits 81,559 MiB.

The module adds ~80 s to the run (granite's cell ~55 s, the full-size
decode cell ~3 s, the JAX subprocess overlapping the rest).
"""
import json
import math
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch, get_reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed.sharding import (local_slices,  # noqa: E402
                                              param_pspecs)
from repro_torch.kernels import flash_attention as kf  # noqa: E402
from repro_torch.launch import cost, dryrun, specs  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.train.optimizer import layer_stacks  # noqa: E402
from repro_torch.tree import get_path, leaves_with_path, path_str  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARCH = "llama3.2-3b"
TINY = ("tiny_train", 64, 8, "train")   # seq, global batch: accum 2 over 4

_JAX_SCRIPT = """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    from repro.configs import get_reduced
    from repro.configs.base import ShapeConfig
    from repro.core.jax_compat import make_mesh
    from repro.launch import hlo_analysis
    from repro.launch.specs import build_train_cell

    arch = get_reduced(sys.argv[1])
    shape = ShapeConfig(*json.loads(sys.argv[2]))
    mesh = make_mesh((4, 1), ("data", "model"))
    cell = build_train_cell(arch, shape, mesh)
    with mesh:
        compiled = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                           donate_argnums=(0, 1)).lower(
                               *cell.abstract_args).compile()
    leaves = {}
    flat = jax.tree_util.tree_flatten_with_path(cell.abstract_args)[0]
    for (path, av), sh in zip(flat,
                              jax.tree_util.tree_leaves(cell.in_shardings)):
        name = "/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                        for e in path)
        leaves[name] = int(np.prod(sh.shard_shape(av.shape))) \\
            * np.dtype(av.dtype).itemsize
    print(json.dumps({
        "argument_bytes": int(compiled.memory_analysis()
                              .argument_size_in_bytes),
        "leaves": leaves, "notes": cell.notes,
        "flops": hlo_analysis.analyze(compiled.as_text()).flops,
        "devices": len(jax.devices())}))
"""


@pytest.fixture(scope="module", autouse=True)
def jax_dry_run(tmp_path_factory):
    """The JAX train cell's compile (``_JAX_SCRIPT``), started with the
    module's first test so that it overlaps the others."""
    d = tmp_path_factory.mktemp("jax_dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    with open(d / "out.txt", "w") as out, open(d / "err.txt", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT), ARCH,
             json.dumps(TINY)], env=env, stdout=out, stderr=err, text=True)
    run = dict(proc=proc, dir=d)
    yield run
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _parity_mesh():
    return AbstractMesh((4, 1), ("data", "model"))


def _tiny_cell():
    return specs.build_train_cell(get_reduced(ARCH), ShapeConfig(*TINY),
                                  _parity_mesh())


def _jax_name(port_name: str, stacks) -> str:
    """The JAX argument leaf a port argument leaf belongs to: a layer's
    leaf ``…/layers/<i>/<sub>`` is part of its group's stacked leaf
    ``…/groups/<g>/l<j>_<kind>/<sub>``."""
    parts = port_name.split("/")
    if "layers" in parts:
        at = parts.index("layers")
        i = int(parts[at + 1])
        group = next(name for name, _, idx in stacks if i in idx)
        parts = parts[:at] + group.split("/") + parts[at + 2:]
    return "/".join(parts)


def _attention_dots(arch, shape, accum: int) -> float:
    """The flops of JAX ``_sdpa``'s dots in one device's train step:
    q·kᵀ and p·v over every (query, key) pair (masked ones too), each
    2·b·h·T²·dh, in the forward and in its remat recompute, and the
    backward's four products (dq, dk, dP, dv) — 16·b·h·T²·dh a layer a
    microbatch, b = 1 sequence a replica."""
    t = shape[1]
    return 16.0 * arch.n_heads * t * t * arch.dh * arch.n_layers * accum


def test_jax_dry_run_parity(jax_dry_run):
    """(a) module docstring."""
    cell = _tiny_cell()
    _, got = cost.trace_step(cell.step_fn, cell.abstract_args,
                             comm=cell.comm)
    rc = jax_dry_run["proc"].wait(timeout=600)
    assert rc == 0, (jax_dry_run["dir"] / "err.txt").read_text()[-3000:]
    ref = json.loads((jax_dry_run["dir"] / "out.txt").read_text().strip()
                     .splitlines()[-1])
    assert ref["devices"] == 4
    arch = get_reduced(ARCH)
    stacks = layer_stacks(arch)
    ours = {}
    for path, x in leaves_with_path(list(cell.abstract_args)):
        name = _jax_name(path_str(path), stacks)
        ours[name] = ours.get(name, 0) + x.numel() * x.element_size()
    differ = sorted(k for k in set(ours) | set(ref["leaves"])
                    if ours.get(k) != ref["leaves"].get(k))
    assert not differ, [(k, ours.get(k), ref["leaves"].get(k))
                        for k in differ]
    assert got.argument_bytes == ref["argument_bytes"], (
        got.argument_bytes, ref["argument_bytes"])
    accum = int(cell.notes.split("accum=")[1].split()[0])
    assert f"accum={accum} " in ref["notes"]
    attn = {op: n for op, n in got.flops_by_op.items()
            if op.startswith("repro_torch.flash_attn")}
    ours_rest = got.flops - sum(attn.values())
    jax_attn = _attention_dots(arch, TINY, accum)
    jax_rest = ref["flops"] - jax_attn
    print(f"port flops {got.flops:.6e}: outside attention {ours_rest:.6e}, "
          f"by operator {got.flops_by_op}; JAX flops {ref['flops']:.6e}: "
          f"_sdpa's dots {jax_attn:.6e}, outside attention {jax_rest:.6e}; "
          f"ratio {ours_rest / jax_rest:.6f}")
    assert set(attn) == {"repro_torch.flash_attn_lse",
                         "repro_torch.flash_attn_bwd"}
    assert abs(ours_rest / jax_rest - 1) < 0.02


def _leaf_parts(params, mesh):
    """(leaf, its placement, the element count of rank 0's part) of every
    parameter, placed as ``FSDPTrainer`` places it."""
    placed = param_pspecs(params, mesh, mode="train", cfg=get_reduced(ARCH))
    for path, x in leaves_with_path(params):
        spec = get_path(placed, path)
        part = math.prod(len(range(*sl.indices(n))) for sl, n in
                         zip(local_slices(x.shape, spec, mesh, 0), x.shape))
        yield x, spec, part


@pytest.mark.parametrize("shape", [(4,), (4, 1)])
def test_recording_comm_bytes(shape):
    """(b) The FSDP step's collectives, from the placements: every leaf's
    parts gathered (bf16, n parts each, replicated leaves too); the split
    leaves' float32 gradient parts reduce-scattered; the whole leaves'
    float32 gradients all-reduced, with one float32 scalar a microbatch
    (the label count), the loss and the clip's sum of squares."""
    names = ("data",) if len(shape) == 1 else ("data", "model")
    mesh = AbstractMesh(shape, names)
    cell = specs.build_train_cell(get_reduced(ARCH), ShapeConfig(*TINY),
                                  mesh)
    cost.trace_step(cell.step_fn, cell.abstract_args, comm=cell.comm)
    params = specs.abstract_params(get_reduced(ARCH), cell.opts)
    n, accum = mesh.size, 2
    gather = scatter = reduce = 0
    for x, spec, part in _leaf_parts(params, mesh):
        gather += n * part * x.element_size()
        if all(a is None for a in spec):
            reduce += x.numel() * 4
        else:
            scatter += part * 4
    reduce += 4 * accum + 4 + 4
    assert cell.comm.bytes == {"all-gather": gather, "all-reduce": reduce,
                               "reduce-scatter": scatter, "all-to-all": 0,
                               "collective-permute": 0}


def _attn_inputs(dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=g).to(dtype)
    return (rand(2, 24, 4, 16), rand(2, 30, 2, 16), rand(2, 30, 2, 16),
            rand(2, 3, 2, 16), rand(2, 3, 2, 16), rand(2, 24, 4, 16))


CASES = [dict(), dict(window=9), dict(causal=False), dict(softcap=2.5),
         dict(window=5, softcap=1.5)]


def _same(a, b) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a, b))


@pytest.mark.parametrize("kw", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_operators_match_plain_versions(kw, dtype):
    """(c) Through each operator on the CPU: the plain version's bits;
    on meta tensors (the fake kernel): its shapes and dtypes."""
    q, k, v, kn, vn, do = _attn_inputs(dtype)
    full = {**dict(causal=True, window=None, scale=None, softcap=0.0), **kw}
    args = (full["causal"], full["window"], full["scale"],
            float(full["softcap"]))
    ops = torch.ops.repro_torch
    want = kf.flash_attention_plain(q, k, v, **kw)
    got = ops.flash_attn(q, k, v, *args)
    assert _same(got, want)
    assert _same(kf.flash_attention(q, k, v, **kw), want)
    o2, lse = ops.flash_attn_lse(q, k, v, *args)
    w2, wlse = kf.flash_attention_plain(q, k, v, return_lse=True, **kw)
    assert _same(o2, w2) and _same(lse, wlse) and _same(o2, want)
    app = ops.flash_attn_appended(q, k, v, kn, vn, *args)
    assert _same(app, kf.flash_attention_plain(q, k, v, k_new=kn,
                                               v_new=vn, **kw))
    grads = ops.flash_attn_bwd(q, k, v, o2, do, lse, *args)
    wants = kf.flash_attention_bwd_plain(q, k, v, o2, do, lse, **kw)
    assert all(_same(a, b) for a, b in zip(grads, wants))
    meta = [t.to("meta") for t in (q, k, v, kn, vn, do, o2, lse)]
    mq, mk, mv, mkn, mvn, mdo, mo, mlse = meta
    shapes = [ops.flash_attn(mq, mk, mv, *args),
              *ops.flash_attn_lse(mq, mk, mv, *args),
              ops.flash_attn_appended(mq, mk, mv, mkn, mvn, *args),
              *ops.flash_attn_bwd(mq, mk, mv, mo, mdo, mlse, *args)]
    for fake, real in zip(shapes, [want, o2, lse, app, *grads]):
        assert fake.device.type == "meta"
        assert (fake.shape, fake.dtype) == (real.shape, real.dtype)


def test_flash_attention_fn_gradients_through_operators():
    """``FlashAttentionFn`` (what training runs) reaches K-F with lse and
    K-B through their operators: the plain versions' forward bits and
    gradient bits on the CPU."""
    q, k, v, _, _, do = _attn_inputs(seed=1)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = kf.FlashAttentionFn.apply(*leaves, True, 7, None, 0.0)
    grads = torch.autograd.grad(out, leaves, do)
    o, lse = kf.flash_attention_plain(q, k, v, window=7, return_lse=True)
    want = kf.flash_attention_bwd_plain(q, k, v, o, do, lse, window=7)
    assert _same(out.detach(), o)
    assert all(_same(a, b) for a, b in zip(grads, want))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 0, 1, 6, 40])
def test_visible_pairs_counts_the_mask(causal, window):
    for nq, nk in ((1, 1), (5, 5), (7, 19), (19, 7), (32, 32)):
        mask = kf._tile_mask(nq, nk, 0, nq, 0, nk, causal=causal,
                             window=window, dev="cpu").expand(nq, nk)
        assert kf.visible_pairs(nq, nk, causal, window) == int(mask.sum())


@pytest.mark.parametrize("mesh_shape", [(1,), (4,)])
def test_trace_flops_equal_flop_counter_mode(mesh_shape):
    """The dry run counts with ``FlopCounterMode``'s formulas in its own
    dispatch mode: the same count as ``FlopCounterMode`` over the same
    step (one device: ``make_train_step``; 4 ranks: ``FSDPTrainer``)."""
    from torch.utils.flop_counter import FlopCounterMode
    mesh = AbstractMesh(mesh_shape, ("data",))
    arch = get_reduced(ARCH)
    cell = specs.build_train_cell(arch, ShapeConfig(*TINY), mesh)
    _, got = cost.trace_step(cell.step_fn, cell.abstract_args,
                             comm=cell.comm)
    cell = specs.build_train_cell(arch, ShapeConfig(*TINY), mesh)
    with FlopCounterMode(display=False) as counter:
        cell.step_fn(*cell.abstract_args)
    assert got.flops == counter.get_total_flops() > 0
    assert got.peak_bytes >= got.argument_bytes + got.output_bytes \
        - got.alias_bytes
    assert got.temp_bytes > 0


def test_full_size_decode_cell():
    """(d) llama3.2-3b × decode_32k on the production mesh: a dense
    decoder's serving cell, so 32 data replicas of 8 model shards; rank
    0 serves its replica's 4 of the 128 rows with 3 of the 24 heads and 1
    of the 8 kv heads, a 32,768-token read-only cache; the record's fit
    follows from its bytes."""
    t0 = time.perf_counter()
    rec = dryrun.run_cell(ARCH, "decode_32k", multi_pod=False,
                          verbose=False)
    took = time.perf_counter() - t0
    print(f"llama3.2-3b x decode_32k @ 256: {took:.2f} s, {rec}")
    assert took < 30
    m = rec["memory"]
    assert rec["chips"] == 256 and rec["mesh"] == "32x8"
    assert rec["tensor_parallel"] and "tensor parallel" in rec["layout"]
    assert m["fits_hbm"] == (m["peak_bytes"] <= m["hbm_bytes"])
    assert m["peak_bytes"] == (m["argument_bytes"] + m["output_bytes"]
                               + m["temp_bytes"] - m["alias_bytes"])
    # rank 0's weights (an eighth of the 3.21e9 bf16 parameters but the
    # norms) plus 28 layers' k and v cache at 4 x 32,768 x 1 head x 128
    cfg = get_arch(ARCH)
    cache = 2 * cfg.n_layers * 4 * 32768 * 1 * cfg.dh * 2
    weights = cfg.param_count() * 2 / 8
    assert cache + weights < m["argument_bytes"] < cache + 1.01 * weights
    coll = rec["collectives"]
    assert coll["all-reduce"] == (2 * cfg.n_layers + 1) * 4 * cfg.d_model * 2
    assert coll["all-gather"] == 4 * cfg.vocab * 4
    assert rec["roofline"]["collective_link"] == "nvlink"
    assert rec["roofline"]["bottleneck"] in ("memory_s", "compute_s")
    assert rec["cost"]["flops_by_op"]["repro_torch.flash_attn_appended"] > 0


TP_MESH = ((4, 2), ("data", "model"))


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_tensor_parallel_serving_cell(kind):
    """(e) module docstring: the reduced llama (2 layers, d_model 64,
    vocab 512) over model = 2, 8 rows a replica."""
    arch = get_reduced(ARCH)
    seq, cache_len = (64, 0) if kind == "prefill" else (1, 48)
    shape = ShapeConfig(f"tiny_{kind}", seq, 32, kind, cache_len=cache_len)
    mesh = AbstractMesh(*TP_MESH)
    build = (specs.build_prefill_cell if kind == "prefill"
             else specs.build_decode_cell)
    cell = build(arch, shape, mesh)
    _, got = cost.trace_step(cell.step_fn, cell.abstract_args,
                             comm=cell.comm)
    b, t = 8, 2
    assert cell.comm.n == t and not cell.comm.spans_nodes
    assert "TP over model=2" in cell.notes
    act = b * seq * arch.d_model * 2                  # bf16 (b, T, d)
    assert got.collectives == {
        "all-reduce": (2 * arch.n_layers + 1) * act,
        "all-gather": t * b * (arch.vocab // t) * 4,  # float32 logits
        "reduce-scatter": 0, "all-to-all": 0, "collective-permute": 0}
    whole = specs.abstract_params(arch, cell.opts)
    placed = param_pspecs(whole, mesh, mode="serve", cfg=arch)
    want = 0
    for path, x in leaves_with_path(whole):
        split = "model" in get_path(placed, path) or \
            path_str(path).endswith(("k/w", "v/w"))
        want += x.numel() * x.element_size() // (t if split else 1)
    params = cell.abstract_args[0]
    assert sum(x.numel() * x.element_size()
               for _, x in leaves_with_path(params)) == want
    assert params["layers"][0]["attn"]["q"]["w"].shape == (64, 2 * arch.dh)
    assert params["layers"][0]["attn"]["k"]["w"].shape == (64, arch.dh)
    if kind == "decode":
        assert cell.abstract_args[2]["layers"][0]["k"].shape == \
            (b, cache_len, 1, arch.dh)


def test_other_cells_keep_the_data_parallel_layout():
    """A MoE arch's train cells and the unsplit archs' serving and train
    cells have no model axis on the production mesh, and their records
    say why (A10e: training MoE / MLA over "model"; A10c: the blocks not
    split yet); a MoE arch's serving cells and a dense arch's train cell
    have one."""
    t, why = mesh_mod.model_extent(get_arch("deepseek-v2-lite-16b"),
                                   "decode")
    assert t == 8 and "experts 8 of 64" in why
    t, why = mesh_mod.model_extent(get_arch("xlstm-350m"), "decode")
    assert t == 1 and "A10c" in why and "slstm" in why
    for arch in ("deepseek-v2-lite-16b", "arctic-480b", "xlstm-350m",
                 "recurrentgemma-9b", "whisper-small", "qwen2-vl-7b"):
        t, why = mesh_mod.model_extent(get_arch(arch), "train")
        label = "A10e" if arch in ("deepseek-v2-lite-16b",
                                   "arctic-480b") else "A10c"
        assert t == 1 and label in why and "FSDP" in why, arch
    t, why = mesh_mod.model_extent(get_reduced(ARCH), "train")
    assert t == 4 and "FSDP over the data axes × tensor parallel" in why
    assert mesh_mod.model_extent(get_arch("granite-34b"), "prefill")[0] == 8
    assert mesh_mod.make_production_mesh(multi_pod=True, model=8).shape \
        == {"pod": 2, "data": 32, "model": 8}
    rec = dryrun.run_cell("xlstm-350m", "decode_32k", multi_pod=False,
                          verbose=False)
    assert rec["mesh"] == "256" and not rec["tensor_parallel"]
    assert "A10c" in rec["layout"] and rec["collectives"]["total"] == 0
    assert "no_fit_reason" not in rec
    big = cost.StepCost(argument_bytes=2 ** 30, output_bytes=2 ** 20,
                        peak_bytes=100 * 2 ** 30)
    why = dryrun.no_fit_reason(big, "B=32 replicated on 64 replicas T=8")
    assert why.startswith("peak 100.0 GiB over 79.6 GiB, 99.0 GiB of it "
                          "temporaries") and "every replica serves" in why


def test_tensor_parallel_train_cell_links():
    """(f) module docstring: the reduced llama's train cell over ``(16,
    2)``, traced: the model axis's bytes over NVLink, the data axis's
    over the network."""
    arch = get_reduced(ARCH)
    mesh = AbstractMesh((16, 2), ("data", "model"))
    cell = specs.build_train_cell(arch, ShapeConfig(*TINY), mesh)
    assert "TP over model=2" in cell.notes and "32 ranks" in cell.notes
    _, got = cost.trace_step(cell.step_fn, cell.abstract_args,
                             comm=cell.comm)
    links = got.collectives_by_link
    assert links["nvlink"] > 0 and links["network"] > 0
    assert links["nvlink"] + links["network"] == sum(
        got.collectives.values())
    # the model axis: all-reduces only; the data axis: the weights'
    # all-gather and the gradients' reduce-scatter
    assert links["nvlink"] <= got.collectives["all-reduce"]
    assert got.collectives["all-gather"] > 0
    assert got.collectives["reduce-scatter"] > 0
    params = cell.abstract_args[0]
    d = arch.d_model // 16
    assert params["layers"][0]["attn"]["q"]["w"].shape == (d, 2 * arch.dh)
    assert params["embed"].shape == (arch.vocab // 2, d)
    assert dryrun.roofline(got)["collective_s"] == pytest.approx(
        links["nvlink"] / dryrun.NVLINK_BW
        + links["network"] / dryrun.NETWORK_BW)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen3-14b",
                                  "nemotron-4-15b", "granite-34b"])
def test_dense_train_cells_are_tp_replicas(arch, multi_pod):
    """(f): each dense decoder's train_4k cell on the production mesh is
    rank 0 of a TP replica over a node's 8 cards: its model shard's
    heads and vocabulary rows, cut again over "data"."""
    from repro_torch.distributed.tensor_parallel import tp_holders
    cfg = get_arch(arch)
    t, why = mesh_mod.model_extent(cfg, "train")
    assert t == 8, why
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod, model=t)
    assert mesh.shape["data"] == 32 and mesh.shape["model"] == 8
    cell = specs.build_cell(cfg, "train_4k", mesh)
    assert cell.kind == "train" and cell.comm.n == mesh.size
    assert f"TP over model=8 (rank 0's model shard: {cfg.n_heads // 8} " \
        f"heads" in cell.notes
    params = cell.abstract_args[0]
    q = params["layers"][0]["attn"]["q"]["w"]
    assert q.shape == (cfg.d_model // 32, cfg.n_heads // 8 * cfg.dh)
    k = params["layers"][0]["attn"]["k"]["w"]
    assert k.shape == (cfg.d_model // 32, max(cfg.n_kv_heads // 8, 1)
                       * cfg.dh)
    assert params["embed"].shape == (cfg.vocab // 8, cfg.d_model // 32)
    # rank 0 holds 1/256 of each leaf cut over both axes, 1/32 of a leaf
    # its model shard holds whole (a norm; granite's one kv head)
    whole = specs.abstract_params(cfg, cell.opts)
    placed = param_pspecs(whole, mesh, mode="train",
                          kv_heads_divide=cfg.n_kv_heads % 8 == 0)
    want = 0
    for path, x in leaves_with_path(whole):
        spec = get_path(placed, path)
        want += x.numel() // ((32 if "data" in spec else 1)
                              * len(tp_holders(path, spec, cfg, 8)))
    assert sum(x.numel() for _, x in leaves_with_path(params)) == want
    assert want <= 1.03 * cfg.param_count() / 256


def test_granite_train_cell_fits():
    """(f): granite-34b × train_4k on ``(32, 8)`` fits the card (its
    1-D cell needed 179.0 GiB, PERF.md §6)."""
    rec = dryrun.run_cell("granite-34b", "train_4k", multi_pod=False,
                          verbose=False)
    assert rec["mesh"] == "32x8" and rec["tensor_parallel"]
    assert rec["memory"]["fits_hbm"], rec["memory"]
    assert "no_fit_reason" not in rec
    links = rec["collectives"]["by_link"]
    assert links["nvlink"] > 0 and links["network"] > 0
    assert rec["roofline"]["collective_link"] == "nvlink+network"
