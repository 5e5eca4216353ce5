"""AdamW — a port of `repro.optim.adamw`.

Parameters may be bf16; the moments and the update math are f32 (no f32
master copy: the update is computed in f32 and cast back to the
parameter's dtype).  Global-norm clipping over every gradient, bias
correction, decoupled weight decay, in the reference's operations and
order.  The update runs under `torch.no_grad`, in place on the given
parameter and moment tensors; a large leaf is updated in slices along
its first axis, which bounds the f32 scratch and computes the same
values.

On the split path (`parallel.sharding.split_mesh`, which the
training step installs) each rank holds blocks of the params, gradients
and moments and updates its blocks; the global norm is then the square
root of the sum of squares over every block, each leaf counted once: the
leaves split over the same mesh axes (the installed mesh's `leaf_axes`)
are summed together and all-reduced over those axes (a leaf is whole,
and equal, on the ranks along every other axis).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.parallel.collectives import all_reduce_
from repro_torch.parallel.sharding import split_mesh
from repro_torch.tree import tree_flatten, tree_map

# elements of one f32 scratch slice (256 MB)
SLICE = 1 << 26


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor        # int32, 0-d
    mu: Any
    nu: Any


def adamw_init(params: Any) -> AdamWState:
    leaves = tree_flatten(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
        mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def _slices(t: torch.Tensor):
    """Index ranges along axis 0 that keep each slice near SLICE
    elements (the whole leaf when it is small or 0-d)."""
    if t.dim() == 0 or t.numel() <= SLICE:
        return [slice(None)]
    per = max(1, SLICE // max(1, t.numel() // t.shape[0]))
    return [slice(i, i + per) for i in range(0, t.shape[0], per)]


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: AdamWState, lr, *,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0
                 ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns (params, the new AdamWState,
    {"grad_norm": the pre-clip global norm}); the trees returned hold the
    tensors passed in."""
    flat_p = tree_flatten(params)
    flat_g = tree_flatten(grads)
    flat_m = tree_flatten(state.mu)
    flat_v = tree_flatten(state.nu)
    dev = flat_p[0].device
    step = state.step + 1

    def sq(g):
        return sum(torch.sum(torch.square(g[s].float())) for s in _slices(g))
    mesh = split_mesh()
    if mesh is None:
        gnorm = torch.zeros((), device=dev)
        for g in flat_g:                 # the reference's sum, leaf order
            gnorm = gnorm + sq(g)
    else:
        groups: Dict[Tuple[str, ...], torch.Tensor] = {}
        for g, axes in zip(flat_g, mesh.leaf_axes, strict=True):
            groups[axes] = groups.get(axes, torch.zeros((), device=dev)) \
                + sq(g)
        gnorm = torch.zeros((), device=dev)
        for axes in sorted(groups):
            part = groups[axes]
            for name in axes:
                all_reduce_(part, mesh.group(name), axis=name)
            gnorm = gnorm + part
    gnorm = torch.sqrt(gnorm)
    # a tensor divided by a tensor: torch takes `scalar / tensor` as a
    # reciprocal times the scalar, which rounds apart from a quotient
    clip = torch.full((), grad_clip, device=dev)
    scale = torch.clamp_max(clip / torch.clamp_min(gnorm, 1e-9), 1.0)
    stepf = step.float()
    b1c = 1.0 - b1 ** stepf
    b2c = 1.0 - b2 ** stepf
    lr = torch.as_tensor(lr, dtype=torch.float32).to(dev)
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        for s in _slices(p):
            gs = g[s].float() * scale
            ms = m[s].mul_(b1).add_((1 - b1) * gs)
            vs = v[s].mul_(b2).add_((1 - b2) * torch.square(gs))
            pf = p[s].float()
            delta = ((ms / b1c) / (torch.sqrt(vs / b2c) + eps)
                     + weight_decay * pf)
            p[s].copy_(pf - lr * delta)
    return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm}
