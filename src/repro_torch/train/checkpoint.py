"""Checkpoint/restore, PyTorch port of the JAX package's
``train.checkpoint`` (npz-based), with its on-disk layout:

    <dir>/step_<N>/
        manifest.json     — step, each leaf's shard, dtype and shape
        shard_<i>.npz     — the leaves, keyed by their tree path

* writes are atomic (a ``.tmp_ckpt_*`` directory renamed into place): a
  crash mid-save never corrupts the latest checkpoint, and
  :func:`latest_step` ignores the leftovers;
* every leaf is keyed by its tree path (``repro_torch.tree.path_str``);
  :func:`restore` takes the structure, dtypes and devices of a target
  tree and raises ``KeyError`` for a leaf the checkpoint misses and
  ``ValueError`` for a shape that differs;
* numpy has no bfloat16: a bf16 leaf is stored as its bits (``uint16``)
  with ``"dtype": "bfloat16"`` in the manifest, and restored to the same
  bits;
* the leaves are whole whatever the run's shard count: ``restore`` with
  ``shardings`` gives each leaf to a function that cuts a shard's part
  out of it (``train.fsdp``), so a checkpoint restores onto any shard
  count — the JAX package's elastic restore.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..tree import get_path, leaves_with_path, path_str, tree_map

__all__ = ["save", "latest_step", "restore"]

_MAX_SHARD_BYTES = 512 * 1024 * 1024


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save(directory: str, step: int, tree: Any) -> str:
    """Serialize a tree (params / opt state / anything) atomically."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    manifest = {"step": step, "leaves": {}, "shards": []}
    shard, shard_bytes, shard_id = {}, 0, 0

    def flush():
        nonlocal shard, shard_bytes, shard_id
        if not shard:
            return
        fname = f"shard_{shard_id}.npz"
        np.savez(os.path.join(tmp, fname), **shard)
        manifest["shards"].append(fname)
        shard, shard_bytes, shard_id = {}, 0, shard_id + 1

    for path, leaf in leaves_with_path(tree):
        key = path_str(path)
        arr, dtype = _to_numpy(leaf)
        manifest["leaves"][key] = {
            "shard": shard_id, "dtype": dtype, "shape": list(arr.shape)}
        shard[key.replace("/", "__")] = arr
        shard_bytes += arr.nbytes
        if shard_bytes >= _MAX_SHARD_BYTES:
            flush()
    flush()
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(directory: str, target: Any, step: Optional[int] = None,
            shardings: Any = None) -> Tuple[Any, int]:
    """Restore into the structure of ``target`` (a tree of tensors: each
    leaf gives the dtype, device and shape to restore to). ``shardings``:
    a tree matching ``target`` of functions from a whole checkpointed
    leaf to the part ``target`` holds (a shard's part). Returns ``(tree,
    step)``."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    cache = {}

    def load(key):
        meta = manifest["leaves"][key]
        fname = manifest["shards"][meta["shard"]]
        if fname not in cache:
            cache[fname] = np.load(os.path.join(d, fname))
        return cache[fname][key.replace("/", "__")], meta["dtype"]

    paths = iter(path for path, _ in leaves_with_path(target))

    def one(tgt):
        path = next(paths)
        key = path_str(path)
        if key not in manifest["leaves"]:
            raise KeyError(f"checkpoint misses leaf {key}")
        arr, dtype = load(key)
        full = _from_numpy(arr, dtype)
        part = full if shardings is None else get_path(shardings, path)(full)
        if list(part.shape) != list(tgt.shape):
            raise ValueError(
                f"shape mismatch for {key}: ckpt {tuple(part.shape)}"
                + ("" if shardings is None else f" (of {arr.shape})")
                + f" vs {tuple(tgt.shape)}")
        return part.to(device=tgt.device, dtype=tgt.dtype, copy=True)

    return tree_map(one, target), step
