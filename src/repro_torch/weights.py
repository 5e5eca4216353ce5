"""Carry the reference's parameters into the port.

`params_from_reference` takes the pytree `repro.nn.model.init_params`
returns, with numpy leaves (``jax.tree.map(np.asarray, params)``), and
returns the port's params: the same tree — including the stacked (L, ...)
leaves of scanned segments that `stack_plan` gives — as torch tensors.

Matrices and the embedding table are stored in bf16: every use in the
reference casts them to the bf16 activation dtype first, so the values the
model computes with are identical.  Norm scales stay f32, as RMSNorm
computes in f32, and so do the leaves some use reads in f32
(`nn.model.F32_LEAVES`: the MoE router, MLA's W_uk and W_uv, which the
absorbed decode folds in f32).  At gemma-7b's full width that is 17 GB
instead of 34.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.nn.config import ModelConfig
from repro_torch.nn.model import F32_LEAVES
from repro_torch.nn.transformer import stack_plan


def params_from_reference(np_params: Any, cfg: ModelConfig,
                          device="cuda") -> Any:
    """Reference params (numpy leaves) -> port params on `device`."""
    dev = resolve_device(device)
    n_seg = len(np_params["stack"]["segments"])
    if n_seg != len(stack_plan(cfg)):
        raise ValueError(f"params hold {n_seg} stack segments; "
                         f"{cfg.name}'s stack plan has {len(stack_plan(cfg))}")

    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, key) for v in node]
        dtype = (torch.float32 if key == "scale" or key in F32_LEAVES
                 else torch.bfloat16)
        return torch.from_numpy(np.array(node)).to(device=dev, dtype=dtype)

    return walk(np_params, None)
