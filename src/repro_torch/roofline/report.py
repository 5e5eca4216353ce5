"""Aggregate the dry run's cells (results/dryrun_torch/*.json) into a
markdown roofline table and a summary — PyTorch port of
`repro.roofline.report`.

    PYTHONPATH=src python -m repro_torch.roofline.report [--dir results/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List


def load_cells(directory: str) -> List[Dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def fmt_s(x) -> str:
    if x is None:
        return "—"
    if x >= 1.0:
        return f"{x:.2f}s"
    return f"{x*1e3:.1f}ms"


def markdown_table(cells: List[Dict]) -> str:
    rows = ["| arch | shape | mesh | GB/dev | fits | compute | memory | "
            "collective | dominant | useful-FLOPs |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for c in cells:
        r = c.get("roofline")
        if r:
            rows.append(
                f"| {c['arch']} | {c['shape']} | {c['mesh']} | "
                f"{c['per_device_gb']:.1f} | {'✓' if c['fits_hbm'] else '✗'} | "
                f"{fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} | "
                f"{fmt_s(r['collective_s'])} | {r['dominant']} | "
                f"{r['useful_flops_ratio']:.2f} |")
        else:
            rows.append(
                f"| {c['arch']} | {c['shape']} | {c['mesh']} | "
                f"{c['per_device_gb']:.1f} | {'✓' if c['fits_hbm'] else '✗'} | "
                f"—  | — | — | (sharding-proof run) | — |")
    return "\n".join(rows)


def summary(cells: List[Dict]) -> str:
    single = [c for c in cells if c["mesh"] == "pod16x16" and c.get("roofline")]
    lines = [f"cells: {len(cells)} total, {len(single)} with roofline"]
    worst = sorted(single, key=lambda c: c["roofline"]["useful_flops_ratio"])
    coll = sorted(single, key=lambda c: -c["roofline"]["collective_s"])
    if worst:
        w = worst[0]
        lines.append(f"worst useful-FLOPs: {w['arch']}×{w['shape']} "
                     f"({w['roofline']['useful_flops_ratio']:.2f})")
        c0 = coll[0]
        lines.append(f"most collective-bound: {c0['arch']}×{c0['shape']} "
                     f"({c0['roofline']['collective_s']:.2f}s)")
    misfit = [c for c in cells if not c["fits_hbm"]]
    lines.append("over-HBM cells: " + (", ".join(
        f"{c['arch']}×{c['shape']}×{c['mesh']}" for c in misfit) or "none"))
    return "\n".join(lines)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--dir", default=os.path.join("results",
                                                "dryrun_torch"))
    args = p.parse_args()
    cells = load_cells(args.dir)
    print(markdown_table(cells))
    print()
    print(summary(cells))


if __name__ == "__main__":
    main()
