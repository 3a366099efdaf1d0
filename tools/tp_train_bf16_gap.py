#!/usr/bin/env python3
"""How far a bf16 train step over a ``("data", "model")`` mesh sits from
one device's, beside how far one device's bf16 step sits from float32's,
on llama3.2-3b's geometry narrowed to run on a CPU.

    PYTHONPATH=src python3 tools/tp_train_bf16_gap.py [--layers 8]
        [--head-dim 32] [--seq 256] [--meshes 2x4,1x8] [--device cpu]

The model is llama3.2-3b's config (GQA 24 / 8, SwiGLU, tied embedding)
with ``--layers`` layers, head_dim ``--head-dim`` (d_model 24 times it),
``d_ff`` and the vocabulary cut by d_model / 3,072 (the vocabulary to a
multiple of 8), seeded bf16 weights, AdamW at the launcher's settings
(lr 1e-3, warmup 10) without remat (which changes no number). Two steps
on 4 seeded rows of ``--seq`` tokens run on one device in bf16, in
float32 (the same weights, widened), and through ``train.fsdp``'s
trainer over each mesh of ``--meshes`` (data x model; every shard on
``--device``). For each run against one device's bf16 run it prints the
loss and grad norm of each step (relative gaps) and the float32 master
weights after step 2: the worst leaf's ‖M − M_1‖ / ‖M_1 − M_0‖ and
| ‖M − M_0‖ / ‖M_1 − M_0‖ − 1 | (M_1 one device's, M_0 the initial
weights). The mesh rounds each layer's partial outputs of o and down,
the vocabulary's sums and the replicated activations' gradients in parts
where one device rounds once; this says how that compares with bf16's
own error, which is what ``chip_smoke.py``'s ``TP_TRAIN_LIMITS`` are set
from. ~2 min on a CPU at the defaults. Imports nothing of JAX."""
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
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=32)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--meshes", default="2x4,1x8")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)

    import torch
    from repro_torch import configs
    from repro_torch.data import DataConfig, synthetic_lm_batch
    from repro_torch.device import resolve_device
    from repro_torch.distributed import make_mesh
    from repro_torch.models import ModelOptions, init_params
    from repro_torch.train import OptConfig, TrainConfig, make_train_step
    from repro_torch.train.fsdp import FSDPTrainer
    from repro_torch.tree import leaves, tree_map

    dev = resolve_device(args.device)
    base = configs.get_arch("llama3.2-3b")
    width = base.n_heads * args.head_dim
    scale = width / base.d_model
    cfg = dataclasses.replace(
        base, n_layers=args.layers, d_model=width, head_dim=args.head_dim,
        d_ff=int(base.d_ff * scale) // 8 * 8,
        vocab=int(base.vocab * scale) // 8 * 8)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=10,
                                     decay_steps=2))
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                synthetic_lm_batch(DataConfig(vocab=cfg.vocab,
                                              seq_len=args.seq,
                                              global_batch=4), i).items()}
               for i in range(2)]

    def weights(dtype):
        opts = ModelOptions(dtype=torch.bfloat16, remat=False)
        p = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                        opts, device=dev)
        return tree_map(lambda x: x.to(dtype), p)

    def one_device(dtype):
        opts = ModelOptions(dtype=dtype, remat=False)
        init, step = make_train_step(cfg, tcfg, opts)
        p = weights(dtype)
        s, ms = init(p), []
        for b in batches:
            p, s, m = step(p, s, b)
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        return ms, [x.float() for x in leaves(s["master"])]

    m0 = [x.float() for x in leaves(weights(torch.bfloat16))]
    ref, m1 = one_device(torch.bfloat16)

    def gaps(ms, masters) -> dict:
        up = length = 0.0
        for a, w, w0 in zip(masters, m1, m0):
            u = max(float((w - w0).norm()), 1e-30)
            up = max(up, float((a - w).norm()) / u)
            length = max(length, abs(float((a - w0).norm()) / u - 1.0))
        return dict(
            loss_rel=[abs(a - b) / abs(b) for (a, _), (b, _) in
                      zip(ms, ref)],
            grad_norm_rel=[abs(a - b) / abs(b) for (_, a), (_, b) in
                           zip(ms, ref)],
            master_gap_update=up, master_update_length=length)

    out = {"config": dict(layers=cfg.n_layers, d_model=cfg.d_model,
                          head_dim=cfg.dh, d_ff=cfg.d_ff, vocab=cfg.vocab,
                          seq=args.seq, rows=4),
           "one_device_bf16": ref}
    ms32, p32 = one_device(torch.float32)
    out["float32_vs_bf16"] = gaps(ms32, p32)
    del p32
    for spec in args.meshes.split(","):
        d, t = (int(x) for x in spec.split("x"))
        mesh = make_mesh((d, t), ("data", "model"), devices=[dev] * (d * t))
        tr = FSDPTrainer(cfg, tcfg, ModelOptions(dtype=torch.bfloat16,
                                                 remat=False), mesh)
        local, states = tr.init(weights(torch.bfloat16))
        ms = []
        for b in batches:
            local, states, m = tr.step(local, states, b)
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        masters = tr.whole([s["master"] for s in states])
        out[f"mesh_{spec}_vs_one_device"] = gaps(ms, leaves(masters))
        del local, states, tr, masters
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
