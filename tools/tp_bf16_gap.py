#!/usr/bin/env python3
"""How far a tensor-parallel replica's bf16 logits sit from one device's,
beside how far one device's bf16 logits sit from float32's, on qwen3-14b's
geometry narrowed to run on a CPU.

    PYTHONPATH=src python3 tools/tp_bf16_gap.py [--layers 40] [--shards 8]
        [--width 1280] [--device cpu]

The model is qwen3-14b's config (GQA 40 / 8, per-head q / k RMSNorm,
SwiGLU) with ``--layers`` layers, ``d_model`` = ``--width``, head_dim
``width / 40``, ``d_ff`` a quarter of qwen3's and a vocabulary of 8,192,
seeded weights in bf16. One prefill of 4 seeded rows of 48 tokens runs on
one device in bf16 and in float32 (the same weights, widened) and over
``--shards`` model shards (``distributed.tensor_parallel``, every shard on
``--device``); prints, for the served (last) position, ‖Δ‖ / ‖one‖ and
max |Δ| of the replica against one device and of one device's bf16
against its float32, and whether the greedy tokens agree. The replica
rounds each layer's ``--shards`` partial outputs of o and down and the
sums between them where one device rounds the whole product once; this
says how that compares with bf16's own error, which is what
``chip_smoke.py``'s ``TP_LOGIT_REL`` is set from. ~7 min on a CPU at 40
layers. Imports nothing of JAX."""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=40)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)

    import torch
    from repro_torch import configs
    from repro_torch.device import resolve_device
    from repro_torch.distributed import LocalComm, make_mesh
    from repro_torch.distributed.tensor_parallel import (gather_vocab,
                                                         shard_params_tp)
    from repro_torch.models import ModelOptions, forward, init_params
    from repro_torch.tree import tree_map

    dev = resolve_device(args.device)
    base = configs.get_arch("qwen3-14b")
    cfg = dataclasses.replace(
        base, n_layers=args.layers, d_model=args.width,
        head_dim=args.width // base.n_heads, d_ff=base.d_ff // 32 * 8,
        vocab=8192)
    bf16 = ModelOptions(dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         bf16, device=dev)
    toks = torch.randint(0, cfg.vocab, (4, 48),
                         generator=torch.Generator().manual_seed(1))
    mesh = make_mesh((1, args.shards), ("data", "model"),
                     devices=[dev] * args.shards)
    comm = LocalComm(mesh).axis("model")
    with torch.no_grad():
        one = forward(params, cfg, toks, opts=bf16, mode="prefill")[0][:, -1]
        wide = forward(tree_map(lambda x: x.float(), params), cfg, toks,
                       opts=ModelOptions(dtype=torch.float32),
                       mode="prefill")[0][:, -1]
        parts = forward(shard_params_tp(params, cfg, mesh), cfg, toks,
                        opts=bf16, mode="prefill", comm=comm)[0]
        tp = gather_vocab(comm, [x[:, -1] for x in parts], cfg.vocab)[0]

    def gap(a, b):
        return dict(rel_norm=float((a - b).norm() / b.norm()),
                    max_abs=float((a - b).abs().max()))

    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    out = dict(device=where, layers=args.layers, width=args.width,
               shards=args.shards, tp_vs_one=gap(tp, one),
               bf16_vs_float32=gap(one, wide),
               logit_max_abs=float(one.abs().max()),
               greedy_equal=bool((tp.argmax(-1) == one.argmax(-1)).all()))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
