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
tensor lives on a mesh.  `place` turns whole leaves into this rank's
blocks under a sharding tree (an uneven split raises, naming the leaf and
the axis) and `gather_whole` rebuilds whole leaves from the blocks.

Two paths split their work over an installed mesh:

  * the split path: the dense GQA and the MoE families in training
    (`launch.steps.split_shardings` decides; `launch.steps.make_train_step`
    installs the path for its step with `splitting`, and the layers read
    it with `split_mesh`).  Every rank holds its block of the params and
    AdamW state, computes its block of the batch over the batch axes and
    its block of the heads (GQA's, or MLA's with the latents whole over
    `model`), ff, experts and vocab over `model`, and carries the
    residual stream as its ("batch", "sp", None) block, gathered along
    the sequence over `model` before attention and the MLP and
    reduce-scattered after them; the MoE layer routes the block itself
    through its all-to-all body.  FSDP leaves are gathered over `data` at
    each use.  The collectives are `parallel.collectives`' Functions;
  * the MoE layer's whole-tensor path (prefill and decode under a mesh,
    `nn.moe`), whose expert-parallel bodies slice each rank's block out of
    the whole tensors the rank holds.

Every other layer holds whole tensors on every rank.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
import threading
from typing import Any, Callable, Optional, Tuple, Union

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
    split: bool = False   # the split path is on (`splitting`)
    # on it, the mesh axes each param leaf is split over (`split_axes`),
    # one tuple a leaf in `tree_flatten` order
    leaf_axes: Optional[Tuple[Tuple[str, ...], ...]] = None

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


def splitting(ctx: MeshCtx, leaf_axes) -> MeshCtx:
    """`ctx` with the split path on (the same groups), each param leaf
    split over the mesh axes `leaf_axes` names for it."""
    out = copy.copy(ctx)
    out.split = True
    out.leaf_axes = tuple(tuple(a) for a in leaf_axes)
    return out


def split_mesh() -> Optional["MeshCtx"]:
    """The installed mesh when the split path is on, else None."""
    ctx = current_mesh()
    return ctx if ctx is not None and ctx.split else None


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
    mesh.  A constraint says where a value lives, never what it is; the
    split path's layers move their blocks with explicit collectives
    (`parallel.collectives`) where the reference's constraints change a
    layout."""
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


# ------------------------------------------------------------- placement
def spec_axes(entry: Axis) -> Tuple[str, ...]:
    """The mesh axes of one PartitionSpec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def split_axes(sharding: "NamedSharding") -> Tuple[str, ...]:
    """Every mesh axis a leaf is split over, in spec order."""
    return tuple(a for e in sharding.spec for a in spec_axes(e))


def local_shape(shape, sharding: "NamedSharding") -> Tuple[int, ...]:
    """A leaf's per-device shape under its placements (uneven splits
    rounded up, as DTensor's first shards are)."""
    from torch.distributed.tensor import Shard
    shape = list(shape)
    mesh = sharding.mesh
    for i, p in enumerate(sharding.placements()):
        if isinstance(p, Shard):
            shape[p.dim] = -(-shape[p.dim] // mesh.size(i))
    return tuple(shape)


def whole_shape(shape, sharding: "NamedSharding") -> Tuple[int, ...]:
    """A block's shape times the mesh axes its dims are split over."""
    mesh = sharding.mesh
    return tuple(n * math.prod(axis_size(mesh, a) for a in spec_axes(e))
                 for n, e in zip(shape, tuple(sharding.spec)
                                 + (None,) * (len(shape) - len(sharding.spec))))


def map_placed(fn: Callable, values, shardings, path=()):
    """`fn(path, leaf, NamedSharding)` over a value tree and its sharding
    tree (dicts, lists, tuples, dataclasses such as AdamWState); a leaf
    whose sharding is None is kept as it is."""
    if isinstance(shardings, NamedSharding):
        return fn(path, values, shardings)
    if shardings is None or values is None:
        return values
    if isinstance(shardings, dict):
        return {k: map_placed(fn, values[k], shardings[k], path + (k,))
                for k in values}
    if isinstance(shardings, (list, tuple)):
        return type(values)(map_placed(fn, v, s, path + (i,)) for i, (v, s)
                            in enumerate(zip(values, shardings)))
    if dataclasses.is_dataclass(shardings):
        return dataclasses.replace(values, **{
            f.name: map_placed(fn, getattr(values, f.name),
                               getattr(shardings, f.name), path + (f.name,))
            for f in dataclasses.fields(shardings)})
    raise TypeError(f"{path}: no sharding tree node {shardings!r}")


def flat_shardings(shardings) -> list:
    """A sharding tree's NamedShardings in `tree.tree_flatten`'s order
    (dict keys sorted), the order of the value tree's leaves."""
    if isinstance(shardings, NamedSharding):
        return [shardings]
    if isinstance(shardings, dict):
        return [x for k in sorted(shardings)
                for x in flat_shardings(shardings[k])]
    if isinstance(shardings, (list, tuple)):
        return [x for s in shardings for x in flat_shardings(s)]
    if dataclasses.is_dataclass(shardings):
        return [x for f in dataclasses.fields(shardings)
                for x in flat_shardings(getattr(shardings, f.name))]
    return []


def _coords(mesh):
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError(f"this rank is not in the mesh {mesh}")
    return dict(zip(mesh.mesh_dim_names, coord))


def block_of(t: torch.Tensor, sharding: "NamedSharding", path=()
             ) -> torch.Tensor:
    """This rank's block of the whole leaf `t` (a view).  Raises where a
    dim does not split evenly over its mesh axes."""
    mesh = sharding.mesh
    coords = _coords(mesh)
    for dim, entry in enumerate(sharding.spec):
        idx, n = 0, 1
        for a in spec_axes(entry):
            size = axis_size(mesh, a)
            idx, n = idx * size + int(coords[a]), n * size
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(
                f"{'/'.join(map(str, path)) or 'leaf'}: dim {dim} of "
                f"{tuple(t.shape)} does not split evenly over mesh axis "
                f"{entry!r} ({n} blocks)")
        size = t.shape[dim] // n
        t = t.narrow(dim, idx * size, size)
    return t


def place(tree, shardings):
    """Whole leaves -> this rank's blocks under `shardings`, each a tensor
    of its own (the whole leaf can be freed)."""
    return map_placed(
        lambda path, t, sh: block_of(t, sh, path).clone(
            memory_format=torch.contiguous_format), tree, shardings)


def gather_whole(tree, shardings):
    """Every rank's blocks -> the whole leaves, on every rank (the
    inverse of `place`; collectives over the mesh's axis groups, outside
    autograd)."""
    from repro_torch.parallel.collectives import _gather_dim

    def whole(path, t, sh):
        mesh = sh.mesh
        t = t.detach()
        for dim, entry in enumerate(sh.spec):
            for a in reversed(spec_axes(entry)):     # innermost first
                t = _gather_dim(t, mesh.get_group(a), dim)
        return t.contiguous()
    return map_placed(whole, tree, shardings)


def batch_block(batch, ctx: MeshCtx):
    """This rank's rows of every (B, ...) leaf of a global batch dict, the
    block of the batch axes that the reference's batch sharding hands
    it."""
    idx, n = 0, 1
    for name in (("pod", "data") if ctx.has_pod else ("data",)):
        idx, n = idx * ctx.size(name) + ctx.index(name), n * ctx.size(name)
    out = {}
    for k, t in batch.items():
        if t.shape[0] % n:
            raise ValueError(f"batch leaf {k!r} of {tuple(t.shape)} does not "
                             f"split over the batch axes ({n} blocks)")
        rows = t.shape[0] // n
        out[k] = t.narrow(0, idx * rows, rows)
    return out
