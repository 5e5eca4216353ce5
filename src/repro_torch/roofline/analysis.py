"""Roofline terms from a dry-run count (no real hardware) — PyTorch port
of `repro.roofline.analysis`, with the H100's peaks in place of the TPU's.

    compute term    = FLOPs / (chips × peak_FLOP/s)
    memory term     = bytes / (chips × HBM_bw)
    collective term = collective_bytes / (chips × link_bw)

The dry run (`repro_torch.launch.dryrun`) hands per-device quantities, so
per-device quantities are divided by per-chip peaks directly
(algebraically identical to the global/(chips×·) form).

`HW` is one H100 SXM: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 80 GB, and
NVLink 4 at 450 GB/s a direction (half its 900 GB/s aggregate).  NVLink
joins the cards of one host only: a mesh axis that crosses hosts (a pod
axis) would run at InfiniBand rates, well below it, so the collective
term is priced as the reference prices it, for the single-pod cell.

collective_bytes sums the per-kind wire bytes of every all-gather /
all-reduce / reduce-scatter / all-to-all / collective-permute, read from
HLO text as the reference reads it (`collective_bytes_from_hlo`, and their
-start async variants) or from the records the port's collectives leave
(`collective_bytes_from_records`).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, Optional, Tuple

#: NVIDIA H100 SXM hardware constants (per card; NVIDIA data sheet).
HW = {
    "peak_flops": 989e12,   # dense bf16, tensor cores
    "hbm_bw": 3.35e12,      # bytes/s, HBM3
    "link_bw": 450e9,       # bytes/s, NVLink 4, one direction
    "hbm_bytes": 80 * 1000**3,
}

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

_COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# `%name = TYPE[dims]{layout} kind(...)` — modern HLO omits operand types,
# so transfer sizes derive from the RESULT shape with per-kind wire factors.
_COLL_RE = re.compile(
    r"=\s*(\([^)]*\)|[a-z]+\d*\[[\d,]*\]\S*)\s+("
    + "|".join(_COLL_KINDS)
    + r")(-start)?\(")
_SHAPE_RE = re.compile(r"([a-z]+\d*)\[([\d,]*)\]")
_GROUP_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    if dtype not in _DTYPE_BYTES:
        return 0
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES[dtype]


def _wire_bytes(kind: str, result_bytes: int, group: int) -> float:
    """Per-device bytes crossing links on a ring/bidirectional schedule."""
    g = max(group, 2)
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g * result_bytes   # reduce-scatter + all-gather
    if kind == "all-gather":
        return (g - 1) / g * result_bytes         # result = gathered size
    if kind == "reduce-scatter":
        return (g - 1) * result_bytes             # result = scattered shard
    if kind == "all-to-all":
        return (g - 1) / g * result_bytes
    return float(result_bytes)                    # collective-permute


_GROUP_LIST_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")


def collective_bytes_from_hlo(hlo_text: str, default_group: int = 2
                              ) -> Dict[str, float]:
    """Per-device wire bytes of collective ops, by kind.

    ``default_group`` is used when replica_groups={} (all devices).
    Ops inside `while` bodies (lax.scan) appear once in the text; the
    reference's dry run corrects loop multiplicity by depth probes."""
    out = {k: 0.0 for k in _COLL_KINDS}
    counts = {k: 0 for k in _COLL_KINDS}
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        result_sig, kind = m.group(1), m.group(2)
        shapes = _SHAPE_RE.findall(result_sig)
        rbytes = sum(_shape_bytes(d, s) for d, s in shapes)
        gm = _GROUP_RE.search(line)
        if gm:
            group = int(gm.group(2))
        else:
            gl = _GROUP_LIST_RE.search(line)
            group = (gl.group(1).count(",") + 1) if gl else default_group
        out[kind] += _wire_bytes(kind, rbytes, group)
        counts[kind] += 1
    out["total"] = sum(out[k] for k in _COLL_KINDS)
    out.update({f"n_{k}": counts[k] for k in _COLL_KINDS})
    return out


def collective_bytes_from_records(records: Iterable[Tuple[str, int, int]],
                                  default_group: int = 2) -> Dict[str, float]:
    """`collective_bytes_from_hlo`'s dict from (kind, result_bytes, group)
    records, one a collective a rank issued: per-kind wire bytes through
    `_wire_bytes`, their total and the `n_<kind>` counts.  A group of 0
    stands for all devices (`default_group`)."""
    out = {k: 0.0 for k in _COLL_KINDS}
    counts = {k: 0 for k in _COLL_KINDS}
    for kind, rbytes, group in records:
        out[kind] += _wire_bytes(kind, rbytes, group or default_group)
        counts[kind] += 1
    out["total"] = sum(out[k] for k in _COLL_KINDS)
    out.update({f"n_{k}": counts[k] for k in _COLL_KINDS})
    return out


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops_global: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    useful_flops_ratio: float
    collectives: Dict[str, float]

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def roofline_terms(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    cost_analysis: Optional[Dict[str, float]],
    hlo_text: str,
    model_flops_global: float,
) -> RooflineReport:
    cost = cost_analysis or {}
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    coll = collective_bytes_from_hlo(hlo_text)
    compute_s = flops / HW["peak_flops"]
    memory_s = nbytes / HW["hbm_bw"]
    collective_s = coll["total"] / HW["link_bw"]
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    useful = model_flops_global / max(flops * chips, 1.0)
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=flops, bytes_per_device=nbytes,
        collective_bytes_per_device=coll["total"],
        model_flops_global=model_flops_global,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, useful_flops_ratio=useful,
        collectives=coll,
    )
