#!/usr/bin/env python3
"""How far a tensor-parallel replica's bf16 logits sit from one device's,
beside how far one device's bf16 logits sit from float32's, on a config
narrowed to run on a CPU.

    PYTHONPATH=src python3 tools/tp_bf16_gap.py [--arch qwen3-14b]
        [--layers N] [--shards N] [--width W] [--reduced] [--device cpu]

``--arch qwen3-14b`` (the default): qwen3-14b's config (GQA 40 / 8,
per-head q / k RMSNorm, SwiGLU) with ``--layers`` layers (40),
``d_model`` = ``--width`` (1,280), head_dim ``width / 40``, ``d_ff`` a
quarter of qwen3's and a vocabulary of 8,192. ``--arch
deepseek-v2-lite-16b`` or ``arctic-480b``: the full config narrowed to
``d_model`` = ``--width`` (256 / 448, an eighth / a sixteenth) with
every FFN width cut by the same factor, its heads, MLA's dims, experts,
top-k, capacity factor and depth kept (``--layers`` cuts it), a
vocabulary of 8,192; with ``--reduced`` the reduced config instead (8
experts top-2, d_model 64) at the full config's depth and capacity
factor (1.25, so capacity drops choices as at full size). Seeded
weights in bf16. One prefill of
4 seeded rows of 48 tokens and three greedy decode steps run on one
device in bf16 and in float32 (the same weights, widened) and over
``--shards`` model shards (``distributed.tensor_parallel``, every shard
on ``--device``; default ``tp_degree(cfg, 8)``), the decode steps fed
one device's bf16 tokens. Prints, for each step's served (last)
position, ‖Δ‖ / ‖one‖ and max |Δ| of the replica against one device and
of one device's bf16 against its float32, whether the greedy tokens
agree and, for a MoE config, the share of routed (token, choice) pairs
whose expert differs (the replica's against one device's, one device's
bf16 against its float32) and the share each run drops. The replica
rounds each layer's partial outputs of o and of the FFN and the sums
between them where one device rounds the whole product once; this says
how that compares with bf16's own error, which is what
``chip_smoke.py``'s ``TP_LOGIT_REL`` and ``TP_MOE_LOGIT_REL`` are set
from. ~7 min on a CPU for qwen3 at 40 layers, seconds for the MoE
configs. Imports nothing of JAX."""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

ARCHS = ("qwen3-14b", "deepseek-v2-lite-16b", "arctic-480b")
STEPS = 3


WIDTH = {"qwen3-14b": 1280, "deepseek-v2-lite-16b": 256,
         "arctic-480b": 448}


def config(arch: str, layers, width, reduced: bool):
    from repro_torch import configs
    base = configs.get_arch(arch)
    width = width or WIDTH[arch]
    depth = layers or base.n_layers
    if arch == "qwen3-14b":
        return dataclasses.replace(
            base, n_layers=depth, d_model=width,
            head_dim=width // base.n_heads, d_ff=base.d_ff // 32 * 8,
            vocab=8192)
    if reduced:
        cfg = configs.get_reduced(arch)
        return dataclasses.replace(cfg, n_layers=depth, moe=dataclasses.replace(
            cfg.moe, capacity_factor=base.moe.capacity_factor))
    cut = base.d_model // width
    mo = base.moe
    return dataclasses.replace(
        base, n_layers=depth, d_model=width, d_ff=base.d_ff // cut,
        vocab=8192, moe=dataclasses.replace(
            mo, expert_ff=mo.expert_ff // cut,
            dense_residual_ff=mo.dense_residual_ff // cut,
            first_dense_ff=mo.first_dense_ff // cut))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS, default="qwen3-14b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--shards", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)

    import torch
    from repro_torch.device import resolve_device
    from repro_torch.distributed import LocalComm, make_mesh
    from repro_torch.distributed.tensor_parallel import (shard_params_tp,
                                                         tp_degree)
    from repro_torch.models import ModelOptions, init_cache, init_params, moe
    from repro_torch.serve import ServeConfig, make_serve_step
    from repro_torch.tree import tree_map

    dev = resolve_device(args.device)
    cfg = config(args.arch, args.layers, args.width, args.reduced)
    shards = args.shards or tp_degree(cfg, 8)
    bf16 = ModelOptions(dtype=torch.bfloat16)
    f32 = ModelOptions(dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         bf16, device=dev)
    toks = torch.randint(0, cfg.vocab, (4, 48),
                         generator=torch.Generator().manual_seed(1))
    mesh = make_mesh((1, shards), ("data", "model"), devices=[dev] * shards)
    comm = LocalComm(mesh).axis("model")

    def steps(p, opts, feed=None, comm=None):
        """The prefill's and STEPS decode steps' served logits (float32
        on the host), the tokens fed, and the MoE's route and drop logs
        (the replica's shard 0)."""
        prefill, decode = make_serve_step(cfg, ServeConfig(), opts,
                                          comm=comm)
        cache = init_cache(cfg, toks.shape[0], toks.shape[1] + STEPS, opts,
                           device=dev, comm=comm)
        moe.route_log, moe.drop_log = [], []
        try:
            lg, cache = prefill(p, toks.to(dev), cache)
            out, fed = [lg.float().cpu()], []
            for s in range(STEPS):
                tok = (torch.argmax(lg, -1).to(torch.int32) if feed is None
                       else feed[s])
                fed.append(tok)
                lg, cache = decode(p, tok[:, None].to(dev), cache)
                out.append(lg.float().cpu())
            routes = [r[1] for r in moe.route_log if r[0] == 0]
            return out, fed, routes, moe.drop_log
        finally:
            moe.route_log = moe.drop_log = None

    with torch.no_grad():
        one, feed, r_one, d_one = steps(params, bf16)
        wide, _, r_wide, _ = steps(tree_map(lambda x: x.float(), params),
                                   f32, feed)
        tp, _, r_tp, d_tp = steps(shard_params_tp(params, cfg, mesh), bf16,
                                  feed, comm)

    def gap(a, b):
        return [dict(rel_norm=float((x - y).norm() / y.norm()),
                     max_abs=float((x - y).abs().max()))
                for x, y in zip(a, b)]

    def differ(a, b):
        n = sum(x.numel() for x in b)
        return sum(int((x != y).sum()) for x, y in zip(a, b)) / max(n, 1)

    def dropped(log):
        return 1.0 - sum(k for k, _ in log) / max(sum(r for _, r in log), 1)

    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    out = dict(device=where, arch=args.arch, reduced=args.reduced,
               layers=cfg.n_layers,
               width=cfg.d_model, shards=shards,
               tp_vs_one=gap(tp, one), bf16_vs_float32=gap(one, wide),
               logit_max_abs=float(one[0].abs().max()),
               greedy_equal=[bool((a.argmax(-1) == b.argmax(-1)).all())
                             for a, b in zip(tp, one)])
    if cfg.moe is not None:
        out.update(routing_differs_tp_vs_one=differ(r_tp, r_one),
                   routing_differs_bf16_vs_float32=differ(r_one, r_wide),
                   dropped_one=dropped(d_one), dropped_tp=dropped(d_tp))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
