"""The port's six examples (``examples/*_torch.py``) on the CPU, each at a
tiny size with ``--device cpu``, called in-process through its
``main(argv)``; the quickstart held against the JAX package on the same
rows and config, and the train example's restart held bit for bit
against an uninterrupted run.

Tolerances: the quickstart's distances within ``ULP_BOUND`` of the JAX
package's (ROADMAP C1), ids equal except among tied distances, the §6
``JoinStats`` integer fields equal (both packages draw the same random
pivots from R) but ``pairs_computed``, within 2 pairs of it, also over
the JAX index carried into the port (the port's pruned reducer takes a
query's distance to each pivot in float64 rounded once, ROADMAP C15, the
JAX package in float32, C1: a row at the edge of a query's Theorem 2
ring falls either side); the restarted parameters bit-equal. Adds ~20 s to a serial run (each example a few seconds, the
JAX join ~3 s)."""
import functools
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import assert_same_join  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ("quickstart", "outlier_detection", "forest_selfjoin",
            "distributed_join", "serve_retrieval", "train_lm")
TINY = {
    "quickstart": ["--r-rows", "600", "--s-rows", "900"],
    "outlier_detection": ["--n", "600"],
    "forest_selfjoin": ["--n", "1500"],
    "distributed_join": ["--shards", "4", "--simulate", "--r-rows", "400",
                         "--s-rows", "600"],
    "serve_retrieval": [],
    "train_lm": ["--layers", "2", "--vocab", "512", "--batch", "1",
                 "--seq", "32", "--steps", "3", "--ckpt-every", "2"],
}


def load_example(name: str):
    """``examples/<name>_torch.py`` as a module (the folder is no
    package)."""
    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def quickstart_run() -> dict:
    return load_example("quickstart").main(TINY["quickstart"]
                                           + ["--device", "cpu"])


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_cpu(name, tmp_path):
    """Each example at a tiny size: its own asserts hold, and the numbers
    it returns are those of the run it describes."""
    argv = TINY[name] + ["--device", "cpu"]
    if name == "train_lm":
        argv += ["--ckpt-dir", str(tmp_path)]
    out = quickstart_run() if name == "quickstart" else \
        load_example(name).main(argv)
    if name == "quickstart":
        # 256 pivots over 600 rows: the pivot pairs alone pass |R|·|S|
        assert out["selectivity"] > 0 and 0 < out["tile_selectivity"] <= 1
        assert out["shuffle_tuples"] <= out["naive_shuffle"]
        assert out["result"].distances.shape == (600, 10)
    elif name == "outlier_detection":
        assert out["found"] == 20 and out["n_objects"] == 620
        assert out["precision"] > 0
    elif name == "forest_selfjoin":
        assert set(out) == {"PGBJ", "PBJ", "H-BRJ"}
        assert out["H-BRJ"]["selectivity"] == 1.0
        assert out["PGBJ"]["selectivity"] < out["H-BRJ"]["selectivity"]
    elif name == "distributed_join":
        assert out["shards"] == 4
        # one injected failure on group 1, retried; a speculative twin
        # may add an attempt to a straggler
        assert set(out["attempts"]) == {0, 1, 2, 3}
        assert out["attempts"][1] >= 2 and min(out["attempts"].values()) >= 1
        assert all(0 < n <= 600 for n in out["shipped"].values())
    elif name == "serve_retrieval":
        # 6 requests in waves of 4 and 2, then 2 more, 8 tokens each:
        # one scheduled retrieval a decode step
        assert out["n_submitted"] == out["n_completed"] == 3 * 8
        assert out["n_shed"] == out["n_degraded"] == 0
        assert [len(t) for t in out["tokens"]] == [8] * 6
        assert out["n_segments"] == 2 and out["n_tombstones"] == 128
        assert out["n_entries"] == 64 * 47 + 16 * 47 - 128
    else:
        assert out["start"] == 0 and out["checkpoints"] == [2]
        assert len(out["loss"]) == 3
        assert all(math.isfinite(x) for x in out["loss"] + out["grad_norm"])


def test_quickstart_matches_jax():
    """The quickstart's join against the JAX package's ``knn_join`` on the
    same rows and config: distances within ULP_BOUND, ids but at ties,
    the §6 integer stats equal; ``pairs_computed`` within 2 pairs, also
    when the port joins over the JAX package's index."""
    pytest.importorskip("jax")
    from repro.core import JoinConfig as JConfig
    from repro.core import build_index as j_build_index
    from repro.core import knn_join as j_knn_join
    from repro.data import forest_like as j_forest_like
    import repro_torch as rt
    from torch_parity import index_arrays
    out = quickstart_run()
    cfg = out["config"]
    r, s = j_forest_like(600, dim=10, seed=0), j_forest_like(900, dim=10,
                                                            seed=1)
    np.testing.assert_array_equal(r, rt.forest_like(600, dim=10, seed=0))
    jcfg = JConfig(k=cfg.k, n_pivots=cfg.n_pivots, n_groups=cfg.n_groups,
                   pivot_strategy=cfg.pivot_strategy, grouping=cfg.grouping)
    want = j_knn_join(r, s, config=jcfg)
    got = out["result"]
    assert_same_join(got.distances, got.indices, want.distances,
                     want.indices)
    for name in ("n_r", "n_s", "replicas_s", "pivot_pairs_computed",
                 "tiles_total", "tiles_visited", "shuffle_tuples"):
        assert getattr(got.stats, name) == getattr(want.stats, name), name
    # the port's pruned reducer takes a query's distance to each pivot in
    # float64 rounded once (C15), the JAX package in float32 (C1), so a
    # row at the edge of a query's Theorem 2 ring can fall either side:
    # 1 of 199,647 pairs at this shape. The same gap over the JAX
    # package's own index (the one-shot join's: its pivots drawn from R)
    # carried into the port shows that the index is not its cause.
    jidx = j_build_index(s, jcfg, pivot_data=r)
    tidx = rt.sindex_from_arrays(index_arrays(jidx), cfg, device="cpu")
    carried = rt.knn_join(r, index=tidx, device="cpu")
    assert_same_join(carried.distances, carried.indices, want.distances,
                     want.indices)
    for name in ("n_r", "n_s", "replicas_s", "tiles_total",
                 "tiles_visited"):
        assert getattr(carried.stats, name) == getattr(want.stats, name), \
            name
    for res in (got, carried):
        assert abs(res.stats.pairs_computed
                   - want.stats.pairs_computed) <= 2


def test_train_lm_restart_is_bitwise(tmp_path):
    """Three uninterrupted steps (a checkpoint at step 2) and a restart
    from that checkpoint give the same parameters, bit for bit."""
    from repro_torch.tree import leaves_with_path
    mod = load_example("train_lm")
    argv = TINY["train_lm"] + ["--device", "cpu", "--ckpt-dir",
                               str(tmp_path)]
    whole = mod.main(argv)
    again = mod.main(argv + ["--restart"])
    assert again["start"] == 2 and len(again["loss"]) == 1
    assert again["loss"][0] == whole["loss"][2]
    a = list(leaves_with_path(whole["params"]))
    b = list(leaves_with_path(again["params"]))
    assert [p for p, _ in a] == [p for p, _ in b] and len(a) > 10
    for (path, x), (_, y) in zip(a, b):
        assert torch.equal(x, y), path
