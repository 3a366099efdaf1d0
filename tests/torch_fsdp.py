"""The FSDP step's drive shared by ``tests/test_torch_sharding.py`` and
the gloo process group's workers it spawns. It imports no JAX, so that a
spawned worker starts in the time ``torch`` and the port take to import."""
import numpy as np
import torch

from repro_torch import configs
from repro_torch.data import DataConfig, synthetic_lm_batch
from repro_torch.distributed import make_mesh
from repro_torch.models import ModelOptions, init_params
from repro_torch.train import OptConfig, TrainConfig
from repro_torch.train.fsdp import FSDPTrainer
from repro_torch.tree import leaves_with_path, path_str

OPTS = ModelOptions(dtype=torch.float32, remat=False, max_abs_pos=4096)


def batch(cfg, step, rows=4, seq=16):
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=rows)
    raw = synthetic_lm_batch(dcfg, step)
    raw["labels"][0, :5] = -1          # the shards' counts differ
    return {k: torch.as_tensor(v) for k, v in raw.items()}


def tcfg(opt):
    return TrainConfig(opt=OptConfig(name=opt, lr=1e-3, warmup_steps=2,
                                     decay_steps=10))


def sharded(cfg, opt, n, steps, comm=None):
    """``steps`` FSDP steps of ``cfg`` over ``n`` shards from seeded
    weights: (trainer, local parameters, local states, metrics)."""
    mesh = make_mesh((n,), ("data",), devices=["cpu"] * n)
    tr = FSDPTrainer(cfg, tcfg(opt), OPTS, mesh, comm)
    p = init_params(cfg, torch.Generator().manual_seed(0), OPTS,
                    device="cpu")
    local, states = tr.init(p)
    ms = []
    for i in range(steps):
        local, states, m = tr.step(local, states, batch(cfg, i))
        ms.append(m)
    return tr, local, states, ms


def pg_worker(rank, world, store_path, out_path):
    """One rank of a gloo group: two steps of each optimizer over
    ``GroupComm``; its shard's parameters and the losses to an npz."""
    import torch.distributed as dist
    from repro_torch.distributed import GroupComm
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        cfg = configs.get_reduced("llama3.2-3b")
        out = {}
        for opt in ("adamw", "adafactor"):
            _, local, _, ms = sharded(cfg, opt, world, 2,
                                      comm=GroupComm(device="cpu"))
            for path, x in leaves_with_path(local[0]):
                out[f"{opt}/{path_str(path)}"] = x.numpy()
            out[f"{opt}/loss"] = np.array([float(m["loss"]) for m in ms])
        np.savez(f"{out_path}.{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
