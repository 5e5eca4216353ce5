"""Logical-axis sharding rules over a device mesh — PyTorch port of
`repro.parallel.sharding`.

Mesh axes: ``("data", "model")`` single pod, ``("pod", "data", "model")``
multi-pod, as a `torch.distributed.device_mesh.DeviceMesh` whose dims carry
those names.  The ``pod`` axis is pure data parallelism; ``data`` carries
both batch sharding and FSDP weight sharding; ``model`` carries
tensor/expert/sequence parallelism.

Logical axes used throughout the model code:

  batch   -> ("pod", "data")      activations' batch dim
  fsdp    -> "data"               weight shards (ZeRO-3 style)
  tp      -> "model"              heads / mlp / vocab / expert dims
  sp      -> "model"              sequence dim of the residual stream &
                                  KV caches (sequence parallelism)

The spec trees (`*_specs`, `launch.steps.*_shardings`) say where each
tensor would live on a mesh.  The port's dense layers hold whole tensors on
every rank, so a sharding constraint (`shard`) changes nothing; only the
MoE layer's expert-parallel bodies (`nn.moe`) split their work over the
mesh, slicing each rank's block out of the whole tensors and moving data
with `torch.distributed` collectives over the mesh's axis groups.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional, Tuple, Union

import torch

_STATE = threading.local()

Axis = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Per tensor dim, the mesh axes it is split over: None, an axis name,
    or a tuple of names.  Entries are normalized as jax's `PartitionSpec`
    normalizes them (a one-name tuple is that name), so a spec equals the
    reference's entry for entry."""

    def __new__(cls, *axes: Axis):
        return super().__new__(cls, tuple(
            a[0] if isinstance(a, tuple) and len(a) == 1 else a
            for a in axes))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass
class MeshCtx:
    """An installed mesh and this rank's place on it: each axis's size,
    the rank's coordinate and the process group of its line along the
    axis, read once when the mesh is installed.  The model code reads
    them here, not from the `DeviceMesh`, whose `mesh` tensor some torch
    versions rebuild on each read: tensor ops inside a rematerialized
    block must be the same in its recomputation."""
    mesh: Any          # torch.distributed.device_mesh.DeviceMesh

    def __post_init__(self):
        names = self.axis_names
        self.sizes = {n: axis_size(self.mesh, n) for n in names}
        coord = self.mesh.get_coordinate()
        self.coords = dict(zip(names, coord)) if coord is not None else None
        self.groups = ({n: self.mesh.get_group(n) for n in names}
                       if coord is not None else None)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names)

    @property
    def has_pod(self) -> bool:
        return "pod" in self.axis_names

    def size(self, name: str) -> int:
        return self.sizes[name]

    def index(self, name: str) -> int:
        """This rank's coordinate along mesh axis `name`
        (`lax.axis_index`)."""
        if self.coords is None:
            raise RuntimeError(f"this rank is not in the mesh {self.mesh}")
        return int(self.coords[name])

    def group(self, name: str):
        """The process group of this rank's line along mesh axis `name`."""
        if self.groups is None:
            raise RuntimeError(f"this rank is not in the mesh {self.mesh}")
        return self.groups[name]


def set_mesh(mesh) -> None:
    _STATE.ctx = MeshCtx(mesh) if mesh is not None else None


def current_mesh() -> Optional[MeshCtx]:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def use_ctx(ctx: Optional[MeshCtx]):
    """Install an installed mesh's `MeshCtx` (or None) in this thread for
    the body of the `with`, restoring the previous one after it: how a
    rematerialized block's recomputation, which autograd may run on
    another thread, sees the mesh its forward ran under."""
    prev = current_mesh()
    _STATE.ctx = ctx
    try:
        yield
    finally:
        _STATE.ctx = prev


def use_mesh(mesh):
    """Install `mesh` in this package's registry (thread-local) for the
    body of the `with`, restoring the previous one after it."""
    return use_ctx(MeshCtx(mesh) if mesh is not None else None)


def batch_axes() -> Axis:
    ctx = current_mesh()
    if ctx is None:
        return None
    return ("pod", "data") if ctx.has_pod else ("data",)


_LOGICAL = {
    "fsdp": "data",
    "tp": "model",
    "sp": "model",
}


def _resolve(axis: Axis) -> Axis:
    if axis == "batch":
        return batch_axes()
    if isinstance(axis, str):
        return _LOGICAL.get(axis, axis)
    return axis


def make_spec(*axes: Axis) -> PartitionSpec:
    """Build a PartitionSpec from logical axis names ('batch', 'fsdp', 'tp',
    'sp', None).  Unknown names pass through as raw mesh axes."""
    return PartitionSpec(*[_resolve(a) for a in axes])


def shard(x: torch.Tensor, *axes: Axis) -> torch.Tensor:
    """The reference's sharding constraint: returns `x`, with or without a
    mesh.  A constraint says where a value lives, never what it is, and
    the port's dense layers hold whole tensors on every rank."""
    return x


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's placement: the mesh and its PartitionSpec."""
    mesh: Any
    spec: PartitionSpec

    def placements(self):
        """The spec as DTensor placements, one per mesh dim: Shard(d) where
        the mesh axis splits tensor dim d, else Replicate()."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in self.mesh.mesh_dim_names:
            dim = next((d for d, e in enumerate(self.spec)
                        if e == name or (isinstance(e, tuple) and name in e)),
                       None)
            out.append(Replicate() if dim is None else Shard(dim))
        return tuple(out)


def named_sharding(*axes: Axis) -> Optional[NamedSharding]:
    ctx = current_mesh()
    if ctx is None:
        return None
    return NamedSharding(ctx.mesh, make_spec(*axes))


def axis_size(mesh, name: str) -> int:
    """The size of a `DeviceMesh`'s axis `name` (`mesh.shape[name]`)."""
    return int(mesh.size(mesh.mesh_dim_names.index(name)))
