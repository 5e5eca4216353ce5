"""Adaptive Partial Weight Reuse (paper §V-C) — PyTorch port of
`repro.core.weight_reuse`.

Re-encode each layer's INT8 weight codes by shifting the layer mean to a
common *Center* so that consecutive layers overwriting the same ReRAM cells
agree on the most-significant 2-bit cells.  Equal cells are skipped; smaller
deltas take fewer programming pulses.  The shift is exactly compensated in
the zero point at de-quantization (see `repro_torch.xbar.quant`), so it is
free.

Codes are torch tensors on any device.  Every statistic the choice of
Center needs — layer means, clip counts, per-cell level histograms before
and after any shift — follows exactly from a layer's 256-bin code
histogram, so the one pass over a layer's codes is a `bincount` on the
codes' device (int64, exact), and the rest is the reference's own float64
numpy arithmetic on the host.  Every decision (center, offsets, clip
rates) therefore equals the reference's bit for bit: the mean is an exact
integer sum over n, as numpy's float64 sum of integer codes is.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.xbar.cells import CELLS_PER_WEIGHT, LEVELS

# The six viable centers of §V-C (mid-points of MSB-cell sections away from
# the clipping extremes).
CENTERS: Tuple[int, ...] = (88, 104, 96, 160, 152, 168)

# |a - b| matrix over the 4 levels of a 2-bit cell.
_ABS_DELTA = np.abs(np.arange(LEVELS)[:, None] - np.arange(LEVELS)[None, :]).astype(np.float64)
_EQ = np.eye(LEVELS, dtype=np.float64)
_CODES = np.arange(256, dtype=np.int64)


def code_hist(codes: torch.Tensor) -> np.ndarray:
    """(256,) int64 histogram of a uint8 code tensor, counted on its device."""
    flat = codes.reshape(-1)
    if flat.numel() == 0:
        return np.zeros(256, np.int64)
    return torch.bincount(flat, minlength=256).cpu().numpy().astype(np.int64)


def shift_hist(hist: np.ndarray, offset: int) -> Tuple[np.ndarray, int]:
    """(histogram of clip(codes + offset, 0, 255), number of codes the
    clip moved) from the histogram of the codes."""
    moved = _CODES + offset
    clipped = int(hist[(moved < 0) | (moved > 255)].sum())
    out = np.zeros(256, np.int64)
    np.add.at(out, np.clip(moved, 0, 255), hist)
    return out, clipped


def hist_mean(hist: np.ndarray) -> float:
    """`np.mean(codes.astype(np.float64))` from the code histogram: the
    exact integer sum over n, rounded once."""
    n = int(hist.sum())
    return int((_CODES * hist).sum()) / n if n else float("nan")


def _cell_hist_of(hist: np.ndarray) -> np.ndarray:
    n = int(hist.sum())
    hists = np.empty((CELLS_PER_WEIGHT, LEVELS), dtype=np.float64)
    for i in range(CELLS_PER_WEIGHT):
        levels = (_CODES >> (2 * i)) & (LEVELS - 1)
        counts = np.array([hist[levels == k].sum() for k in range(LEVELS)],
                          np.int64)
        hists[i] = counts / max(n, 1)
    return hists


def cell_hist(codes: torch.Tensor) -> np.ndarray:
    """Per-cell level histograms, shape (CELLS_PER_WEIGHT, LEVELS)."""
    return _cell_hist_of(code_hist(codes))


#: Histogram of pristine (erased) cells — all at level 0.
ERASED_HIST: np.ndarray = np.tile(
    np.eye(LEVELS, dtype=np.float64)[0], (CELLS_PER_WEIGHT, 1)
)


def expected_pulses_per_weight(hist_old: np.ndarray, hist_new: np.ndarray) -> float:
    """E[Σ_cells |Δ level|] when hist_new overwrites hist_old (random pairing)."""
    total = 0.0
    for i in range(CELLS_PER_WEIGHT):
        total += float(hist_old[i] @ _ABS_DELTA @ hist_new[i])
    return total


def expected_skip_per_cell(hist_old: np.ndarray, hist_new: np.ndarray) -> np.ndarray:
    """Paper Eq. 3 per cell: Σ_k P_old(k)·P_new(k), shape (4,)."""
    return np.array(
        [float(hist_old[i] @ _EQ @ hist_new[i]) for i in range(CELLS_PER_WEIGHT)]
    )


@dataclasses.dataclass(frozen=True)
class LayerEncoding:
    """Re-encoding decision for one layer."""

    name: str
    offset: int                # code-domain shift (0 for first layer / reuse off)
    clip_rate: float           # fraction of codes clipped by the shift
    hist: np.ndarray           # (4, 4) per-cell level histograms after shift


def encode_hists(
    names: Sequence[str],
    hists: Sequence[np.ndarray],
    enabled: bool = True,
    max_clip_rate: float = 1e-3,
    centers: Sequence[int] = CENTERS,
    shift_first_layer: bool = False,
) -> Tuple[List[LayerEncoding], Optional[int]]:
    """`encode_network` over the layers' 256-bin code histograms."""
    if not enabled or len(hists) == 0:
        encs = [LayerEncoding(n, 0, 0.0, _cell_hist_of(h))
                for n, h in zip(names, hists)]
        return encs, None

    best_center, best_score, best_encs = None, -np.inf, None
    for center in centers:
        encs: List[LayerEncoding] = []
        worst_clip = 0.0
        for li, h in enumerate(hists):
            if li == 0 and not shift_first_layer:
                shifted, clip, off = h, 0.0, 0
            else:
                off = int(round(center - hist_mean(h)))
                shifted, n_clipped = shift_hist(h, off)
                clip = n_clipped / max(int(h.sum()), 1)
            worst_clip = max(worst_clip, clip)
            encs.append(LayerEncoding(names[li], off, clip,
                                      _cell_hist_of(shifted)))
        if worst_clip > max_clip_rate:
            continue
        # Score: mean MSB-cell (cells 2, 3) skip ratio over consecutive pairs.
        if len(encs) > 1:
            score = float(
                np.mean(
                    [
                        expected_skip_per_cell(a.hist, b.hist)[2:].sum()
                        for a, b in zip(encs[:-1], encs[1:])
                    ]
                )
            )
        else:
            score = 0.0
        if score > best_score:
            best_center, best_score, best_encs = center, score, encs

    if best_encs is None:  # no center met the accuracy guard → reuse disabled
        encs = [LayerEncoding(n, 0, 0.0, _cell_hist_of(h))
                for n, h in zip(names, hists)]
        return encs, None
    return best_encs, best_center


def encode_network(
    layer_codes: Sequence[Tuple[str, torch.Tensor]],
    enabled: bool = True,
    max_clip_rate: float = 1e-3,
    centers: Sequence[int] = CENTERS,
    shift_first_layer: bool = False,
) -> Tuple[List[LayerEncoding], Optional[int]]:
    """Pick the best common Center for a network and re-encode every layer.

    Follows §V-C: evaluates every candidate center, discards centers whose
    worst-layer clip rate exceeds ``max_clip_rate`` (the accuracy guard), and
    keeps the one maximizing the average expected MSB-cell skip ratio between
    consecutive layers.  The first layer is never shifted (paper: first-layer
    perturbations are disproportionately harmful).

    Returns (encodings, chosen_center).  ``chosen_center`` is None when reuse
    is disabled or no center passes the clip guard.
    """
    return encode_hists([n for n, _ in layer_codes],
                        [code_hist(c) for _, c in layer_codes],
                        enabled=enabled, max_clip_rate=max_clip_rate,
                        centers=centers, shift_first_layer=shift_first_layer)


def pulse_matrix(encodings: Sequence[LayerEncoding]) -> np.ndarray:
    """(L+1, L) expected pulses/weight; row 0 is the erased state."""
    hists = [ERASED_HIST] + [e.hist for e in encodings]
    out = np.zeros((len(hists), len(encodings)))
    for i, ho in enumerate(hists):
        for j, e in enumerate(encodings):
            out[i, j] = expected_pulses_per_weight(ho, e.hist)
    return out
