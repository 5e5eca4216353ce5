"""LR schedules, cosine and WSD (Warmup-Stable-Decay, MiniCPM §4) — a
port of `repro.optim.schedules`, in f32 with the reference's operations
in its order.  Each returns a 0-d f32 tensor on the CPU."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).cpu()


def cosine(step, *, peak_lr: float, warmup: int, total: int,
           floor: float = 0.1) -> torch.Tensor:
    step = _f32(step)
    warm = peak_lr * step / max(warmup, 1)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)


def wsd(step, *, peak_lr: float, warmup: int, stable: int, decay: int,
        floor: float = 0.01) -> torch.Tensor:
    """MiniCPM's Warmup-Stable-Decay: linear warmup, a long flat stage,
    then a decay linear in log to `floor`·peak."""
    step = _f32(step)
    warm = peak_lr * step / max(warmup, 1)
    t = torch.clamp((step - warmup - stable) / max(decay, 1), 0.0, 1.0)
    dec = peak_lr * torch.exp(_f32(math.log(floor)) * t)
    return torch.where(step < warmup, warm,
                       torch.where(step < warmup + stable,
                                   _f32(peak_lr), dec))
