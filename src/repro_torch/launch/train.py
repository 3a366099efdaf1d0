"""Training launcher: ``--arch <id>``, PyTorch port of the JAX package's
``launch.train`` (its flags plus ``--device``, and ``--shards`` and
``--simulate`` as ``launch.join`` has them).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --steps 100 --seq 512 --batch 16 [--ckpt-dir …] [--restart]
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --reduced --device cpu --steps 20 --seq 32 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --reduced --device cpu --steps 4 --seq 32 --batch 4 --shards 2 \\
      --simulate

bf16 with remat at full width, float32 without remat with ``--reduced``,
AdamW; stateless data replay (``synthetic_lm_batch(dcfg, i)`` for step
i), a checkpoint every ``--ckpt-every`` steps, ``--restart`` from the
latest one. Runs on the card unless ``--device cpu``. ``--shards N``
trains over a mesh of N shards along ``"data"`` — the JAX launcher's
host mesh and layout, FSDP (``train.fsdp``) — one a card, or all N on
``--device`` with ``--simulate``; a restart restores onto any shard
count (checkpoints hold whole leaves). ``--tp T`` adds a model axis:
``(N, T)`` shards over ``("data", "model")``, FSDP × tensor parallelism
for the dense decoders (the JAX launcher builds ``("data",)`` only,
ROADMAP C21) — N·T cards, all on ``--device`` with ``--simulate``, or
the devices ``--devices`` lists (N·T entries; ``cpu,cpu,cpu,cpu`` four
on the CPU). With ``--tp`` the whole tree is drawn on the CPU (from the
same seed) and each shard's part placed on its device, so a model larger
than one card starts:

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --reduced --steps 4 --seq 32 --batch 4 --shards 2 --tp 2 \
      --devices cpu,cpu,cpu,cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import ARCH_IDS, get_arch, get_reduced
from ..data import DataConfig, synthetic_lm_batch
from ..device import resolve_device
from ..models import ModelOptions, count_params, init_params
from ..train import OptConfig, TrainConfig, checkpoint, make_train_step


def _mesh(args, dev):
    """The ``--shards`` mesh along "data" (``(N, T)`` over ``("data",
    "model")`` with ``--tp T``): one shard a card, every shard on ``dev``
    with ``--simulate``, or the ``--devices`` list."""
    from ..distributed.mesh import make_mesh
    shape, names = (((args.shards, args.tp), ("data", "model"))
                    if args.tp > 1 else ((args.shards,), ("data",)))
    n = args.shards * args.tp
    if args.devices is not None:
        devices = args.devices.split(",")
        if len(devices) != n:
            raise SystemExit(f"--devices lists {len(devices)} devices for "
                             f"{n} shards")
        return make_mesh(shape, names, devices=devices)
    if args.simulate:
        return make_mesh(shape, names, devices=[dev] * n)
    if dev.type == "cpu" and n > 1:
        raise SystemExit(f"{n} shards on the CPU need --simulate or "
                         f"--devices")
    return make_mesh(shape, names,
                     devices=None if dev.type == "cuda" else [dev])


def main(argv=None) -> dict:
    """Runs the loop; returns each step's loss, grad norm and host
    seconds (the device synchronised at the end of every step), the step
    it started from, and with ``--shards`` each shard's resident
    (parameter, optimizer-state) bytes."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--restart", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=0,
                    help="train over a mesh of N data shards (FSDP)")
    ap.add_argument("--simulate", action="store_true",
                    help="put every shard on --device")
    ap.add_argument("--tp", type=int, default=1,
                    help="model shards of each data replica (FSDP x TP)")
    ap.add_argument("--devices", default=None,
                    help="the shards' devices, comma-separated (default: "
                         "a card a shard)")
    args = ap.parse_args(argv)
    if args.tp > 1:
        args.shards = max(args.shards, 1)
    if args.devices is not None and not args.shards:
        ap.error("--devices places the shards of --shards N")

    cfg = get_reduced(args.arch) if args.reduced else get_arch(args.arch)
    mesh = _mesh(args, None if args.devices else
                 resolve_device(args.device)) if args.shards else None
    dev = (mesh.devices[0] if mesh is not None
           else resolve_device(args.device))
    opts = ModelOptions(dtype=torch.float32 if args.reduced
                        else torch.bfloat16,
                        remat=not args.reduced,
                        max_abs_pos=max(4096, args.seq))
    tcfg = TrainConfig(opt=OptConfig(lr=args.lr, warmup_steps=10,
                                     decay_steps=args.steps),
                       accum=args.accum)
    opt_init, step_fn = make_train_step(cfg, tcfg, opts)

    # over a model axis the whole tree is drawn on the CPU, and only each
    # shard's part reaches its device
    home = torch.device("cpu") if args.tp > 1 else dev
    params = init_params(cfg, torch.Generator(device=home).manual_seed(0),
                         opts, device=home)
    n_params = count_params(params)
    trainer = None
    if mesh is not None:
        from ..train.fsdp import FSDPTrainer
        trainer = FSDPTrainer(cfg, tcfg, opts, mesh)
        params, opt = trainer.init(params)   # each shard's parts
        where = (f"{mesh.size} shards "
                 + (f"({args.shards} x {args.tp} over data x model) "
                    if args.tp > 1 else "")
                 + "on " + ", ".join(sorted(set(map(str, mesh.devices)))))
    else:
        opt = opt_init(params)
        where = str(dev)
    print(f"{cfg.name}: {n_params / 1e6:.1f}M params on {where}", flush=True)
    start = 0
    if args.restart and args.ckpt_dir and \
            checkpoint.latest_step(args.ckpt_dir) is not None:
        if trainer is not None:
            params, opt, start = trainer.restore(args.ckpt_dir, params, opt)
        else:
            restored, start = checkpoint.restore(
                args.ckpt_dir, {"params": params, "opt": opt})
            params, opt = restored["params"], restored["opt"]
        print(f"restored step {start}", flush=True)

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch * max(1, args.accum))
    out = {"start": start, "loss": [], "grad_norm": [], "step_s": []}
    if trainer is not None:
        out["resident_bytes"] = trainer.resident_bytes(params, opt)
        print("resident bytes a shard (parameters, optimizer state): "
              + "; ".join(f"{p} / {o}" for p, o in out["resident_bytes"]),
              flush=True)
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        t_step = time.perf_counter()
        raw = synthetic_lm_batch(dcfg, i)
        if args.accum > 1:
            raw = {k: v.reshape(args.accum, args.batch, -1)
                   for k, v in raw.items()}
        batch = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
        if trainer is not None:
            params, opt, m = trainer.step(params, opt, batch)
        else:
            params, opt, m = step_fn(params, opt, batch)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["step_s"].append(time.perf_counter() - t_step)
        if (i + 1) % 10 == 0:
            print(f"step {i + 1:5d} loss {out['loss'][-1]:.4f} "
                  f"({(time.perf_counter() - t0) / 10:.2f}s/step)",
                  flush=True)
            t0 = time.perf_counter()
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            if trainer is not None:
                trainer.save(args.ckpt_dir, i + 1, params, opt)
            else:
                checkpoint.save(args.ckpt_dir, i + 1,
                                {"params": params, "opt": opt})
    print("done", flush=True)
    return out


if __name__ == "__main__":
    main()
