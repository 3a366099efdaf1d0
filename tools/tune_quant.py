#!/usr/bin/env python3
"""Regenerate the port's quantized-tier tuning table
(``repro_torch.quant.autotune``) on the card.

Sweeps the fp32 megastep against the forced-int8 engine (and the int8
shortlist size ``mp``) with ``autotune.sweep_config`` at the JAX
package's tuning shapes and at the shapes ``chip_smoke.py`` serves, and
writes the winners to the committed table
(``src/repro_torch/quant/TUNE_quant.json`` by default; ``--out`` or
``REPRO_TORCH_QUANT_TUNE_TABLE`` point elsewhere):

    python3 tools/tune_quant.py [--out PATH] [--fast] [--iters 3]
                                [--device cuda|cpu]

Cells are keyed ``(backend, dim, pow2-bucketed n_rows, k)``; cells of
other backends already in the table are kept and only this backend's
(``cuda`` on the card, ``cpu`` with ``--device cpu``) are refreshed.
``--fast`` sweeps only the cells of at most 4,096 rows. Every cell
prints one JSON line (its key, the winner, the int8 and fp32 batch
times, the sweep's seconds, the card's name and power limit). Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

# (name, dim, n_rows, k): the JAX package's SHAPES
# (benchmarks/tune_quant.py) on clustered rows, then the card's own:
# chip_smoke.py's Forest index (phases 8 and 17) and its kNN-LM store
# (phase 14)
SHAPES = [
    ("clustered", 32, 20000, 10),
    ("clustered", 32, 3000, 10),
    ("clustered", 16, 20000, 8),
    ("clustered", 16, 3000, 8),
    ("forest", 10, 581_012, 10),
    ("store", 32, 1_048_576, 8),
]


def _cell(name: str, dim: int, n_rows: int, k: int):
    """The rows and the ``JoinConfig`` a cell is swept at."""
    import numpy as np

    import repro_torch as rt
    if name == "clustered":
        return (rt.clustered_like(n_rows, dim, seed=0),
                rt.JoinConfig(k=k, n_pivots=64, n_groups=8, seed=3))
    if name == "forest":
        return (rt.forest_like(n_rows, dim, seed=0),
                rt.JoinConfig(k=k, n_pivots=256, tile_r=128, tile_s=512))
    rng = np.random.default_rng(14)
    return (rng.standard_normal((n_rows, dim), dtype=np.float32),
            rt.JoinConfig(k=k, n_pivots=128, n_groups=8))


def _card(device) -> str:
    if device.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        import torch
        return torch.cuda.get_device_name(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="table path (default: the committed "
                         "src/repro_torch/quant/TUNE_quant.json)")
    ap.add_argument("--fast", action="store_true",
                    help="sweep only the cells of at most 4,096 rows")
    ap.add_argument("--iters", type=int, default=3,
                    help="timing iterations per candidate (best-of)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import repro_torch as rt
    from repro_torch.device import resolve_device
    from repro_torch.quant import autotune

    dev = resolve_device(args.device)
    backend = dev.type
    path = args.out or autotune.default_table_path()
    table = (autotune.TuningTable.load(path) if os.path.exists(path)
             else autotune.TuningTable())
    card = _card(dev)
    for name, dim, n_rows, k in SHAPES:
        if args.fast and n_rows > 4096:
            continue
        s, cfg = _cell(name, dim, n_rows, k)
        index = rt.build_index(s, cfg, device=dev)
        t0 = time.perf_counter()
        tuned = autotune.sweep_config(index, cfg, iters=args.iters)
        dt = time.perf_counter() - t0
        key = autotune.table_key(dim, n_rows, k, backend)
        table.entries[key] = tuned
        print(json.dumps({
            "cell": key, "rows": name, "n_rows": n_rows, "mode": tuned.mode,
            "mp": tuned.mp, "int8_batch_ms": tuned.int8_batch_s * 1e3,
            "fp32_batch_ms": tuned.fp32_batch_s * 1e3, "sweep_s": dt,
            "card": card}), flush=True)
        del index
    table.save(path)
    autotune.reset_default_table()
    print(f"wrote {len(table.entries)} entries to {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
