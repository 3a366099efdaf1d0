"""Dry run: trace every (arch × shape × mesh) cell's step on one device
over meta tensors — PyTorch port of the JAX package's ``launch.dryrun``.

Answers without hardware, per cell, whether the port's program fits a
card of the production mesh (``launch.mesh``: 256 H100s, or 2 × 256)
and what bounds its step: per-device memory against the card's, flops
and HBM bytes, collective bytes by kind, the three roofline terms and
the useful-flop ratio. The cells are ``SHAPES × runnable_cells``; each
step is what the port runs (``launch.specs``): for the dense decoders,
rank 0 of a tensor-parallel replica over ``"model"`` — FSDP × TP for
train, the TP forward for prefill and decode; for the MoE decoders the
TP forward for prefill and decode (experts and heads split) and FSDP
over the data axes for train; for the other archs, FSDP over the data
axes for train and a data-parallel replica with whole weights for
serving (``launch.mesh.model_extent`` says which, and the
record says why), counted by ``launch.cost``. A cell that does not fit
is a record with ``fits_hbm`` false, not a failure; a cell that raises
is a failure. Allocates nothing and asks for no card.

Usage (the JAX launcher's flags):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-34b \\
      --shape train_4k [--multi-pod] [--out results.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The roofline terms are estimates from the H100 SXM data sheet, not
measurements: compute at the dense bf16 peak, memory at the HBM rate,
collectives at NVLink's rate a direction for a group within a node and
the network's a card for a group across nodes, the two added.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

from ..configs import ARCH_IDS, SHAPES, get_arch, runnable_cells
from .cost import trace_step
from .mesh import make_production_mesh, model_extent
from .specs import build_cell

# H100 SXM data sheet, per card
PEAK_FLOPS = 989e12          # dense bf16 (tensor cores)
HBM_BW = 3.35e12             # B/s
NVLINK_BW = 450e9            # B/s a direction, cards within a node
NETWORK_BW = 50e9            # B/s a card across nodes (400 Gb/s)
# the card's memory as nvidia-smi --query-gpu=memory.total reports it on an
# NVIDIA H100 80GB HBM3 (81,559 MiB)
HBM_BYTES = 81559 * 2 ** 20


def roofline(cost) -> dict:
    """The three terms: flops at the bf16 peak, HBM bytes at its rate,
    and each link's collective bytes at its rate (NVLink within a node,
    the network across nodes)."""
    links = cost.collectives_by_link
    r = {"compute_s": cost.flops / PEAK_FLOPS,
         "memory_s": cost.bytes / HBM_BW,
         "collective_s": (links.get("nvlink", 0) / NVLINK_BW
                          + links.get("network", 0) / NETWORK_BW)}
    r["bottleneck"] = max(r, key=lambda k: r[k])
    return r


def no_fit_reason(cost, notes: str, held_whole: int = 0) -> str:
    """Why a cell's peak passes the card: its largest part of the peak,
    a batch every replica serves whole where the cell replicates it, and
    the ``held_whole`` bytes of weights that the JAX serve layout would
    keep over ``"data"`` (``launch.specs.Cell.held_whole``)."""
    parts = {"arguments (weights, cache, inputs)": cost.argument_bytes,
             "temporaries": cost.temp_bytes, "outputs": cost.output_bytes}
    big = max(parts, key=parts.get)
    why = (f"peak {cost.peak_bytes / 2 ** 30:.1f} GiB over "
           f"{HBM_BYTES / 2 ** 30:.1f} GiB, {parts[big] / 2 ** 30:.1f} GiB "
           f"of it {big}")
    if " replicated on " in notes:
        why += ("; the batch does not split over the data replicas, so "
                "every replica serves every row")
    if held_whole:
        why += (f"; {held_whole / 2 ** 30:.1f} GiB of the weights are "
                f"leaves that the JAX serve layout keeps over 'data' past "
                f"its 128 MiB budget, which the port's replica holds whole "
                f"(ROADMAP A10d)")
    return why


def model_flops(arch, shape, kind: str) -> float:
    """The step's model flops over every device: 6·N_active·tokens for
    train, 2·N_active·tokens for prefill, 2·N_active a decoded token (the
    JAX dry run's rule)."""
    n_active = arch.active_param_count()
    if kind == "decode":
        return 2.0 * n_active * shape.global_batch
    tokens = shape.global_batch * shape.seq_len
    return (6.0 if kind == "train" else 2.0) * n_active * tokens


def run_cell(arch_name: str, shape_name: str, *, multi_pod: bool,
             verbose: bool = True) -> dict:
    """One cell's record (the JAX dry run's field names where the meaning
    is the same)."""
    arch = get_arch(arch_name)
    t, layout = model_extent(arch, SHAPES[shape_name].kind)
    mesh = make_production_mesh(multi_pod=multi_pod, model=t)
    t0 = time.time()
    cell = build_cell(arch, shape_name, mesh)
    rec = {
        "arch": arch_name, "shape": shape_name,
        "mesh": "x".join(str(mesh.shape[a]) for a in mesh.axis_names),
        "mesh_axes": list(mesh.axis_names),
        "chips": mesh.size, "kind": cell.kind, "notes": cell.notes,
        "tensor_parallel": t > 1, "layout": layout,
    }
    rec["build_s"] = round(time.time() - t0, 1)
    t1 = time.time()
    _, cost = trace_step(cell.step_fn, cell.abstract_args, comm=cell.comm)
    rec["trace_s"] = round(time.time() - t1, 1)
    rec["ops_traced"] = cost.n_ops
    rec["memory"] = cost.memory()
    rec["memory"]["hbm_bytes"] = HBM_BYTES
    rec["memory"]["fits_hbm"] = cost.peak_bytes <= HBM_BYTES
    if not rec["memory"]["fits_hbm"]:
        rec["no_fit_reason"] = no_fit_reason(cost, cell.notes,
                                             cell.held_whole)
    rec["cost"] = {"flops": cost.flops, "bytes": cost.bytes,
                   "flops_by_op": cost.flops_by_op}
    rec["collectives"] = dict(cost.collectives)
    rec["collectives"]["total"] = sum(cost.collectives.values())
    rec["collectives"]["by_link"] = dict(cost.collectives_by_link)
    rec["roofline"] = roofline(cost)
    used = [k for k in ("nvlink", "network")
            if cost.collectives_by_link.get(k)]
    rec["roofline"]["collective_link"] = "+".join(used) or "nvlink"
    mf = model_flops(arch, cell.shape, cell.kind) / mesh.size
    rec["model_flops_per_chip"] = mf
    rec["useful_flop_ratio"] = mf / max(cost.flops, 1.0)
    if verbose:
        r, m = rec["roofline"], rec["memory"]
        print(f"[{arch_name} × {shape_name} @ {rec['mesh']}] "
              f"peak={m['peak_bytes'] / 2 ** 30:.2f}GiB "
              f"fits={m['fits_hbm']} "
              f"compute={r['compute_s'] * 1e3:.2f}ms "
              f"memory={r['memory_s'] * 1e3:.2f}ms "
              f"collective={r['collective_s'] * 1e3:.2f}ms "
              f"bottleneck={r['bottleneck']} "
              f"useful={rec['useful_flop_ratio']:.2f} "
              f"build={rec['build_s']}s trace={rec['trace_s']}s "
              f"({rec['notes']})"
              + (f" [does not fit: {rec['no_fit_reason']}]"
                 if "no_fit_reason" in rec else ""), flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for a in ARCH_IDS:
            for s in runnable_cells(get_arch(a)):
                cells.append((a, s))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells = [(args.arch, args.shape)]

    results, failures = [], []
    for a, s in cells:
        try:
            results.append(run_cell(a, s, multi_pod=args.multi_pod))
        except Exception as e:  # noqa: BLE001 — report, keep sweeping
            traceback.print_exc()
            failures.append({"arch": a, "shape": s, "error": repr(e)})
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": results, "failures": failures}, f, indent=1)
    print(f"\n{len(results)} cells OK, {len(failures)} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
