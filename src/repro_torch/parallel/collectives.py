"""Collectives over a mesh's axis groups, as autograd Functions over
`torch.distributed` calls that gloo and NCCL both run, so a training step
differentiates through them.  Eager collectives on plain local tensors,
not DTensor: the flash Function and the dry run's counting modes take
plain tensors.

Two families, by what the loss is on each rank:

  * the MoE layer's whole-tensor path (`nn.moe`, prefill and decode
    under a mesh): every rank computes the same loss from the global
    output, so each rank's backward through a body gives its own share of
    the gradient and `_Replicated` sums the shares at the layer's inputs.
    An output gathered for every rank hands back the rank's own slice
    (`_GatherBlocks`), a sum for every rank passes its gradient through
    (`_Psum`), an all-to-all runs in reverse (`_AllToAll`), and the
    expert weights gathered over 'data' take the split path's
    `all_gather`, whose backward reduce-scatters their gradients;
  * the split path (`launch.steps.split_shardings`: the dense and MoE
    families in training): each rank's loss is its own share, and the
    loss of the step is the sum of the shares (`psum`, whose backward
    passes the gradient through, makes that sum on every rank).  Each
    collective's backward is its transpose over the same group:
    `all_gather` along a dim reduce-scatters the gradient,
    `reduce_scatter` all-gathers it, `all_reduce` all-reduces it, and the
    MoE body's `_AllToAll` exchanges it back.  A leaf's gradient is then
    the one-process gradient once it is summed over the mesh axes the
    leaf is not split over (`launch.steps.make_train_step`).

`recording_collectives()` makes every collective here leave a record
(kind, result bytes, group size), with the mesh axis it ran over as the
record's `axis`, in this thread, for the dry run's collective term
(`repro_torch.launch.dryrun`).  With no recorder open nothing is
recorded.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import MeshCtx, current_mesh

_RECORDER = threading.local()


class Record(tuple):
    """(kind, result bytes, group size) in `repro_torch.roofline.analysis`'s
    kind names, and `axis`, the mesh axis of the group (None when no
    installed mesh names it)."""

    def __new__(cls, kind: str, nbytes: int, group: int,
                axis: Optional[str] = None):
        rec = super().__new__(cls, (kind, nbytes, group))
        rec.axis = axis
        return rec


@contextlib.contextmanager
def recording_collectives():
    """For the body of the `with`, in this thread: a list that every
    collective of this module appends a `Record` to."""
    prev = getattr(_RECORDER, "records", None)
    _RECORDER.records = records = []
    try:
        yield records
    finally:
        _RECORDER.records = prev


def _axis_of(group) -> Optional[str]:
    ctx = current_mesh()
    if ctx is None or ctx.groups is None:
        return None
    return next((n for n, g in ctx.groups.items() if g is group), None)


def _record(kind: str, result: torch.Tensor, group,
            axis: Optional[str] = None) -> None:
    records = getattr(_RECORDER, "records", None)
    if records is not None:
        records.append(Record(kind, result.numel() * result.element_size(),
                              dist.get_world_size(group),
                              axis or _axis_of(group)))


# ------------------------------------------------------------ the calls
def _exchange(t: torch.Tensor, group,
              axis: Optional[str] = None) -> torch.Tensor:
    """Slice i of `t`'s leading axis goes to rank i of the group; slice i
    of the result came from rank i."""
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    _record("all-to-all", out, group, axis)
    return out


def _gather_dim(t: torch.Tensor, group, dim: int,
                axis: Optional[str] = None) -> torch.Tensor:
    """The group's blocks of `t` concatenated along `dim` in rank order,
    one `all_gather_into_tensor`."""
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    _record("all-gather", out, group, axis)
    return out.movedim(0, dim)


def _scatter_dim(t: torch.Tensor, group, dim: int,
                 axis: Optional[str] = None) -> torch.Tensor:
    """The group's sum of `t`, this rank's block of it along `dim`, one
    `reduce_scatter_tensor`; raises where `dim` does not split."""
    n = dist.get_world_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"into {n} blocks")
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    _record("reduce-scatter", out, group, axis)
    return out.movedim(0, dim)


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM,
                axis: Optional[str] = None) -> torch.Tensor:
    """`t` summed (or reduced by `op`) over the group, in place; outside
    autograd."""
    dist.all_reduce(t, op=op, group=group)
    _record("all-reduce", t, group, axis)
    return t


# ------------------------------------------ the MoE bodies' Functions
class _Replicated(torch.autograd.Function):
    """A tensor every rank of the mesh holds whole: the identity forward;
    backward, the ranks' gradient shares summed over every mesh axis, so
    each rank receives the one-process gradient."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        for name in ctx.mesh.axis_names:
            dist.all_reduce(out, group=ctx.mesh.group(name))
        return out, None


class _Owned(torch.autograd.Function):
    """The identity; backward, the gradient on the rank that owns the
    value and zeros on the others (the graph stays the same on every
    rank, so every rank runs the same collectives in the same order)."""

    @staticmethod
    def forward(ctx, t, owner):
        ctx.owner = owner
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.owner else torch.zeros_like(grad)), None


class _GatherBlocks(torch.autograd.Function):
    """Output blocks gathered along `axis` for every rank."""

    @staticmethod
    def forward(ctx, t, group, axis):
        ctx.group, ctx.axis = group, axis
        return _gather_dim(t, group, axis)

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        own = grad.chunk(n, dim=ctx.axis)[dist.get_rank(ctx.group)]
        return own.contiguous(), None, None


class _AllToAll(torch.autograd.Function):
    """`lax.all_to_all(split_axis=0, concat_axis=0)` over the group of
    mesh axis `axis`."""

    @staticmethod
    def forward(ctx, t, group, axis):
        ctx.group, ctx.axis = group, axis
        return _exchange(t, group, axis)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group, ctx.axis), None, None


class _Psum(torch.autograd.Function):
    """`lax.psum` over the group, its result used on every rank: the
    backward passes the gradient through."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        _record("all-reduce", out, group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


# ------------------------------------------------- the split path's Functions
class _AllGather(torch.autograd.Function):
    """Blocks concatenated along `dim`; backward, the gradients summed and
    scattered back along `dim`."""

    @staticmethod
    def forward(ctx, t, group, dim, axis):
        ctx.group, ctx.dim, ctx.axis = group, dim, axis
        return _gather_dim(t, group, dim, axis)

    @staticmethod
    def backward(ctx, grad):
        return (_scatter_dim(grad, ctx.group, ctx.dim, ctx.axis), None, None,
                None)


class _ReduceScatter(torch.autograd.Function):
    """The group's sum, this rank's block along `dim`; backward, the
    blocks' gradients gathered."""

    @staticmethod
    def forward(ctx, t, group, dim, axis):
        ctx.group, ctx.dim, ctx.axis = group, dim, axis
        return _scatter_dim(t, group, dim, axis)

    @staticmethod
    def backward(ctx, grad):
        return (_gather_dim(grad, ctx.group, ctx.dim, ctx.axis), None, None,
                None)


class _AllReduce(torch.autograd.Function):
    """The group's sum on every rank; backward, the gradients summed."""

    @staticmethod
    def forward(ctx, t, group, axis):
        ctx.group, ctx.axis = group, axis
        return all_reduce_(t.clone(memory_format=torch.contiguous_format),
                           group, axis=axis)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(memory_format=torch.contiguous_format),
                           ctx.group, axis=ctx.axis), None, None


def all_gather(t: torch.Tensor, ctx: MeshCtx, axis: str, dim: int
               ) -> torch.Tensor:
    """Mesh axis `axis`'s blocks of `t` concatenated along `dim`."""
    return _AllGather.apply(t, ctx.group(axis), dim, axis)


def reduce_scatter(t: torch.Tensor, ctx: MeshCtx, axis: str, dim: int
                   ) -> torch.Tensor:
    """`t` summed over mesh axis `axis`, this rank's block along `dim`."""
    return _ReduceScatter.apply(t, ctx.group(axis), dim, axis)


def all_reduce(t: torch.Tensor, ctx: MeshCtx, axis: str) -> torch.Tensor:
    """`t` summed over mesh axis `axis`, on every rank of it."""
    return _AllReduce.apply(t, ctx.group(axis), axis)


def all_reduce_max(t: torch.Tensor, ctx: MeshCtx, axis: str) -> torch.Tensor:
    """The elementwise maximum over mesh axis `axis` (no gradient)."""
    return all_reduce_(t.detach().clone(), ctx.group(axis),
                       dist.ReduceOp.MAX, axis)


def psum(t: torch.Tensor, ctx: MeshCtx, axes: Iterable[str]) -> torch.Tensor:
    """`t` summed over each of `axes`, the result taken as every rank's:
    the backward passes the gradient through (see the module
    docstring)."""
    for name in axes:
        t = _Psum.apply(t, ctx.group(name))
    return t
