"""Checkpoints in the reference's format — a port of
`repro.checkpoint.checkpoint`, so that each package restores the other's.

Layout: <dir>/step_<N>/
  manifest.json        — step, a description of the tree, each leaf's
                         shape and logical dtype
  arr_<i>.npy          — one file per leaf, host-gathered

Leaves are numbered in jax's flatten order (`tree.tree_flatten`: dict
keys sorted, lists in order, AdamWState as step, mu, nu), so a trainer
state {"params", "opt"} lists opt.step, opt.mu…, opt.nu…, then params….
bf16 leaves are stored as their uint16 bits (.npy has no bf16); the
manifest names the logical dtype.

  * save is atomic: written to step_<N>.tmp, then renamed, so a
    preemption mid-save never corrupts the latest checkpoint;
  * async: with `block=False` every leaf is copied into private host
    memory at once (a CPU leaf too: the optimizer updates the live
    tensors in place) and written by a background thread while training
    continues;
    `wait_for_saves` joins the writers;
  * restore reads each leaf into the target's dtype and device and
    raises on a shape mismatch;
  * a state held in blocks over a mesh (the split path) passes its
    sharding tree: save gathers the whole leaves on every rank and rank 0
    writes them, in the same format; restore reads the whole leaves on
    every rank and places this rank's blocks
    (`parallel.sharding.place`), as the reference restores with
    shardings.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import (gather_whole, map_placed, place,
                                           whole_shape)
from repro_torch.tree import tree_flatten, tree_unflatten

_SAVE_LOCK = threading.Lock()
_PENDING: List[threading.Thread] = []


def _to_host(t) -> np.ndarray:
    """A private host copy of a leaf, as the numpy array the reference
    writes: bf16 as uint16.  Always a copy: `.cpu()` of a CPU tensor is
    the tensor itself, which the next step's in-place update changes."""
    t = torch.as_tensor(t).detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_name(t) -> str:
    t = torch.as_tensor(t)
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=t.dtype).numpy().dtype)


def save_checkpoint(directory: str, step: int, tree: Any,
                    block: bool = True, shardings: Any = None) -> None:
    """Write `tree` as step `step`.  With `shardings` (a state in blocks
    over a mesh) every rank calls it: the whole leaves are gathered and
    rank 0 writes them."""
    if shardings is not None:
        tree = gather_whole(tree, shardings)
        if dist.get_rank() != 0:
            return
    leaves = tree_flatten(tree)
    host = [_to_host(t) for t in leaves]
    manifest = {
        "step": step,
        "treedef": f"jax flatten order, {len(leaves)} leaves",
        "leaves": [{"shape": list(a.shape), "dtype": _dtype_name(t)}
                   for a, t in zip(host, leaves)],
    }

    def _write():
        with _SAVE_LOCK:
            tmp = os.path.join(directory, f"step_{step}.tmp")
            final = os.path.join(directory, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            for i, a in enumerate(host):
                np.save(os.path.join(tmp, f"arr_{i}.npy"), a)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)

    if block:
        _write()
    else:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        _PENDING.append(t)


def wait_for_saves() -> None:
    for t in _PENDING:
        t.join()
    _PENDING.clear()


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, target: Any,
                       shardings: Any = None) -> Any:
    """Restore into the structure of ``target``: each leaf takes the
    target leaf's dtype and device.  Raises ValueError when a stored
    shape differs from the target's.  With `shardings` the target holds
    this rank's blocks: the whole leaves are read and placed."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        stored = [leaf["dtype"] for leaf in json.load(f)["leaves"]]
    leaves = tree_flatten(target)
    shapes = [tuple(t.shape) for t in leaves]
    if shardings is not None:
        shapes = [tuple(t.shape) for t in tree_flatten(map_placed(
            lambda _, t, sh: torch.empty(whole_shape(t.shape, sh),
                                         device="meta"), target, shardings))]
    out = []
    for i, (ref, shape) in enumerate(zip(leaves, shapes)):
        a = np.load(os.path.join(path, f"arr_{i}.npy"))
        if tuple(a.shape) != shape:
            raise ValueError(f"leaf {i}: checkpoint shape {a.shape} != "
                             f"target {shape}")
        if stored[i] == "bfloat16" or (a.dtype == np.uint16
                                       and ref.dtype == torch.bfloat16):
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        out.append(t.to(device=ref.device, dtype=ref.dtype))
    out = tree_unflatten(target, out)
    return out if shardings is None else place(out, shardings)
