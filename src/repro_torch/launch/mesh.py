"""Device meshes over `torch.distributed` ranks — PyTorch port of
`repro.launch.mesh`.

Production mesh: (data=16, model=16) per pod; (pod=2, data=16, model=16)
across pods, one rank a device.  Functions, not module-level constants,
so importing this module starts no process group.  Like every entry point
of the port, a mesh lives on the card unless the caller asks for the CPU
(`device="cpu"`: gloo in place of NCCL).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(dev: torch.device, shape, axes) -> DeviceMesh:
    """A mesh of `shape` over the leading ranks of the default group."""
    n = math.prod(shape)
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = _world()
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks but only {have} present; start "
            f"{n} processes under torch.distributed, one a device")
    # more ranks than the mesh needs (512 started, single pod): the mesh
    # takes the leading ones
    return _mesh(resolve_device(device), shape, axes)


def make_debug_mesh(data: int = 1, model: int = 1,
                    device="cuda") -> DeviceMesh:
    """A (data, model) mesh over the ranks that exist (tests, one-card
    runs).  With no process group and a 1 x 1 mesh it starts a one-rank
    group on an in-process store: NCCL on the card, gloo on the CPU.  The
    caller that started it ends it (`dist.destroy_process_group()`)."""
    dev = resolve_device(device)
    n = data * model
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a {data} x {model} mesh needs {n} ranks; start them under "
                f"torch.distributed first")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    if _world() < n:
        raise RuntimeError(f"a {data} x {model} mesh needs {n} ranks but "
                           f"only {_world()} present")
    return _mesh(dev, (data, model), ("data", "model"))
