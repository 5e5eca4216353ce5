"""Delta-encoded INT8 weight installs with §V-C mean-centering — PyTorch
port of `repro.streaming.delta`.

The store keeps every layer's weights as uint8 codes (plus dequant params)
in host memory, pinned when it computes on a CUDA device.  Installing
layer Y into an arena slot holding layer X ships ``delta = codes_Y -
codes_X``; cells whose 2-bit planes are equal are skipped entirely, so
bytes-on-wire track the paper's pulse counts.

The §V-C re-encoding (shift every layer's code mean to a common Center,
compensated through the zero point — `repro_torch.core.weight_reuse`)
maximizes equal MSB cells across layers and therefore the skip ratio.

All passes over the codes run in torch on the store's device: the
quantization, the §V-C shift, the code histograms behind the offsets, the
cell-delta histogram of `delta_bytes` and the `pulse_count` kernel behind
`flip_counts`.  The entropy and payload arithmetic over the 7 delta counts
stays on the host in float64, as in the reference, so wire bytes and skip
ratios equal the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.weight_reuse import code_hist, encode_hists, shift_hist
from repro_torch.device import resolve_device
from repro_torch.kernels.pulse_count.ops import pulse_count
from repro_torch.xbar.cells import CELLS_PER_WEIGHT


def flip_counts(old: Optional[torch.Tensor], new: torch.Tensor, *,
                skip_equal: bool = True) -> Tuple[int, int]:
    """(cells programmed, programming pulses) to put `new` codes into a
    region holding `old` (None = erased region: every cell at level 0; a
    `new` longer than `old` programs its tail from erased too).

    skip_equal=True is the §V-C device write: 2-bit planes whose level is
    unchanged are skipped entirely (0 pulses), and a changed cell costs
    |Δ level| incremental SET/RESET pulses (`repro_torch.xbar.cells.pulse_count`,
    the paper's Fig. 13 writing-activity metric).  skip_equal=False is the
    baseline programmer: every cell is rewritten, an unchanged level still
    costing its one write/verify pulse.

    Both follow from the `pulse_count` kernel's two totals over the
    overlap and over the tail against erased cells: with P pulses and U
    unchanged of 4n cells, (4n - U, P) and (4n, P + U)."""
    new = new.reshape(-1)
    n = 0 if old is None else min(old.numel(), new.numel())
    pulses = unchanged = 0
    if n:
        p, u = pulse_count(old.reshape(-1)[:n], new[:n])
        pulses, unchanged = int(p), int(u)
    if new.numel() > n:
        tail = new[n:]
        p, u = pulse_count(torch.zeros_like(tail), tail)
        pulses, unchanged = pulses + int(p), unchanged + int(u)
    cells = CELLS_PER_WEIGHT * new.numel()
    if skip_equal:
        return cells - unchanged, pulses
    return cells, pulses + unchanged


def delta_counts(old: torch.Tensor, new: torch.Tensor) -> np.ndarray:
    """(7,) int64 counts of the per-cell level deltas Δ = new - old in
    [-3, 3] (index Δ + 3), counted on the codes' device.  Each cell plane
    is one `bincount` over (Δ + 3, old code) pairs, summed over the old
    code afterwards: a 7-bin count alone would serialize on the atomics of
    a CUDA histogram, while the old code spreads them over 1,792 bins."""
    o = old.reshape(-1).to(torch.int16)
    w = new.reshape(-1).to(torch.int16)
    counts = torch.zeros(7 * 256, dtype=torch.int64, device=new.device)
    for c in range(CELLS_PER_WEIGHT):
        d = ((w >> (2 * c)) & 3) - ((o >> (2 * c)) & 3) + 3
        counts += torch.bincount(d * 256 + o, minlength=7 * 256)
    return counts.view(7, 256).sum(dim=1).cpu().numpy()


def delta_bytes(old: torch.Tensor, new: torch.Tensor) -> Tuple[int, float]:
    """Bytes-on-wire for an entropy-coded cell-delta stream + skip ratio.

    The install ships per-cell level deltas in [-3, 3].  A range coder on
    that stream achieves the empirical entropy H(Δ) bits/cell (+ a 16-byte
    frequency table); mean-centering (§V-C) concentrates Δ at 0, which is
    exactly what shrinks H — the information-theoretic counterpart of
    skipped ReRAM pulses."""
    counts = delta_counts(old, new).astype(np.float64)
    n = CELLS_PER_WEIGHT * old.numel()
    probs = counts[counts > 0] / n
    entropy_bits = float(-(probs * np.log2(probs)).sum())
    payload = int(np.ceil(n * entropy_bits / 8.0)) + 16
    skip = float(counts[3] / n)  # Δ == 0
    return payload, skip


def wire_cost(old: Optional[torch.Tensor], new: torch.Tensor
              ) -> Tuple[int, float]:
    """(bytes-on-wire, skip ratio) to put `new` codes into a region holding
    `old` (None = cold region → full stream): the cell-delta stream over
    the overlap, the rest of `new` shipped raw."""
    size = new.numel()
    n = 0 if old is None else min(old.numel(), size)
    if n == 0:
        return size, 0.0
    b, skip = delta_bytes(old.reshape(-1)[:n], new.reshape(-1)[:n])
    return b + (size - n), skip


@dataclasses.dataclass
class LayerWeights:
    """One layer's quantized tensors, flattened into a single code vector for
    transfer accounting plus per-tensor views for compute."""

    name: str
    codes: torch.Tensor               # uint8, concatenated, host memory
    shapes: List[Tuple[int, ...]]
    sizes: List[int]
    scales: List[np.float32]
    zero_points: List[np.float32]     # offset-compensated (Eq. 7)
    offset: int = 0

    def tensor(self, i: int) -> torch.Tensor:
        start = sum(self.sizes[:i])
        return self.codes[start:start + self.sizes[i]].reshape(self.shapes[i])

    def dequant(self, i: int) -> torch.Tensor:
        t = self.tensor(i).to(torch.float32)
        return (t - float(self.zero_points[i])) * float(self.scales[i])


def _quantize(w: torch.Tensor) -> Tuple[torch.Tensor, np.float32, np.float32]:
    """Per-tensor uint8 affine quantization, the reference's arithmetic:
    scale and zero point in float64 on the host, the codes in f32 on w's
    device with both rounded to f32 first (numpy's rule for a Python float
    against an f32 array), round half to even."""
    lo, hi = float(w.min()), float(w.max())
    scale = max(hi - lo, 1e-8) / 255.0
    zp = -lo / scale
    sc = torch.tensor(scale, dtype=torch.float32, device=w.device)
    z = torch.tensor(zp, dtype=torch.float32, device=w.device)
    codes = torch.clamp(torch.round(w / sc + z), 0, 255).to(torch.uint8)
    return codes.reshape(-1), np.float32(scale), np.float32(zp)


def _shift(codes: torch.Tensor, offset: int) -> torch.Tensor:
    return torch.clamp(codes.to(torch.int16) + offset, 0, 255).to(torch.uint8)


class QuantizedStore:
    """Host-resident quantized model with cross-layer re-encoding.

    ``offset_groups`` (optional, one label per layer) pools the §V-C offset
    decision: all layers sharing a label get ONE offset computed from their
    pooled codes.  A multi-tenant store groups aligned layers of model
    variants this way — per-layer offsets would shift near-identical tenant
    copies by slightly different amounts (their code means differ by
    rounding), turning a near-zero delta stream into a uniform ±1 shift of
    every cell and destroying the cross-tenant reuse it exists to enable.

    ``device`` is where the store computes.  Layer tensors may lie
    anywhere; each is quantized on ``device``, the codes stay there until
    the offsets are chosen and shifted, then move to host memory (pinned
    for a CUDA device, so installs copy them asynchronously).
    """

    def __init__(self, layers: Sequence[Tuple[str, List[torch.Tensor]]],
                 reuse: bool = True, max_clip_rate: float = 4e-3,
                 offset_groups: Optional[Sequence[object]] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        # Quantize each tensor per-tensor (uint8 affine).
        self.layers: List[LayerWeights] = []
        dev_codes: List[torch.Tensor] = []
        for name, tensors in layers:
            codes, shapes, sizes, scales, zps = [], [], [], [], []
            for w in tensors:
                c, sc, zp = _quantize(w.to(device=self.device,
                                           dtype=torch.float32))
                codes.append(c)
                shapes.append(tuple(w.shape))
                sizes.append(w.numel())
                scales.append(sc)
                zps.append(zp)
            cat = (torch.cat(codes) if codes else
                   torch.zeros(0, dtype=torch.uint8, device=self.device))
            dev_codes.append(cat)
            self.layers.append(LayerWeights(name, cat, shapes, sizes, scales,
                                            zps))

        self.center: Optional[int] = None
        if reuse:
            hists = [code_hist(c) for c in dev_codes]
            if offset_groups is None:
                encs, center = encode_hists(
                    [lw.name for lw in self.layers], hists, enabled=True,
                    max_clip_rate=max_clip_rate)
                offsets = [e.offset for e in encs]
            else:
                assert len(offset_groups) == len(self.layers)
                groups = list(dict.fromkeys(offset_groups))  # stable order
                # Subsample members before pooling: offsets only need group
                # means/histograms (which converge long before 256k samples).
                cap = 1 << 18
                pooled = []
                for g in groups:
                    members = [code_hist(c[::max(1, c.numel() // cap)])
                               for c, gg in zip(dev_codes, offset_groups)
                               if gg == g and c.numel()]
                    if members:
                        pooled.append(sum(members))
                    else:   # the reference pools np.zeros(1, np.uint8)
                        pooled.append(np.eye(1, 256, dtype=np.int64)[0])
                encs, center = encode_hists(
                    [str(g) for g in groups], pooled, enabled=True,
                    max_clip_rate=max_clip_rate)
                off_of = {g: e.offset for g, e in zip(groups, encs)}
                # Per-member accuracy guard: encode_hists only checked the
                # pooled clip rate; a member sitting near the code extremes
                # could clip far above it.  Zero the WHOLE group's offset
                # (not just the member) so aligned tenants stay aligned.
                worst = {g: 0.0 for g in groups}
                for h, c, g in zip(hists, dev_codes, offset_groups):
                    off = off_of[g]
                    if c.numel() and off:
                        clipped = shift_hist(h, off)[1]
                        worst[g] = max(worst[g], clipped / c.numel())
                off_of = {g: (0 if worst[g] > max_clip_rate else o)
                          for g, o in off_of.items()}
                offsets = [off_of[g] for g in offset_groups]
            self.center = center
            for i, (lw, off) in enumerate(zip(self.layers, offsets)):
                if off:
                    dev_codes[i] = _shift(dev_codes[i], off)
                    lw.offset = off
                    # Eq. 7: compensate through the zero point.
                    lw.zero_points = [zp + off for zp in lw.zero_points]
        self._device_copies: Dict[int, torch.Tensor] = {}
        pin = self.device.type == "cuda"
        for lw, c in zip(self.layers, dev_codes):
            host = torch.empty(c.shape, dtype=torch.uint8, pin_memory=pin)
            lw.codes = host.copy_(c)

    def drop_device_copies(self) -> None:
        """Free the layer copies `_on_device` keeps (see there)."""
        self._device_copies.clear()

    def _on_device(self, layer: Optional[int]) -> Optional[torch.Tensor]:
        """A layer's codes on the store's device.  The last two layers
        copied stay there until `drop_device_copies`: a greedy that costs
        one incoming layer against every occupant (or one occupant against
        every incoming layer) copies the layer it holds fixed once.  Codes
        never change after construction, so a kept copy is always
        current."""
        if layer is None:
            return None
        codes = self._device_copies.pop(layer, None)
        if codes is None:
            codes = self.layers[layer].codes.to(self.device,
                                                non_blocking=True)
        self._device_copies[layer] = codes          # most recent last
        while len(self._device_copies) > 2:
            self._device_copies.pop(next(iter(self._device_copies)))
        return codes

    def install_cost(self, resident: Optional[int], incoming: int
                     ) -> Tuple[int, float]:
        """(bytes-on-wire, skip ratio) to put layer `incoming` into a slot
        currently holding `resident` (None = cold slot → full stream)."""
        return wire_cost(self._on_device(resident),
                         self._on_device(incoming))

    def install_flips(self, resident: Optional[int], incoming: int, *,
                      skip_equal: bool = True) -> Tuple[int, int]:
        """(cells programmed, programming pulses) the DEVICE spends putting
        layer `incoming` into a slot holding `resident` (None = cold slot,
        programmed from erased).  This is the physical-write counterpart of
        `install_cost` and is independent of the wire encoding: even when
        the raw code stream ships (delta entropy exceeded 2 bits/cell), a
        skip_equal programmer still read-verifies and skips equal 2-bit
        planes.  skip_equal=False models the no-reuse baseline that
        rewrites every cell."""
        return flip_counts(self._on_device(resident),
                           self._on_device(incoming), skip_equal=skip_equal)
