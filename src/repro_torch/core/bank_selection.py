"""Adaptive Bank Selection (paper §V-A, Eq. 1-2) — a copy of
`repro.core.bank_selection` (pure Python) for the port.

Choose, per layer, the minimal-leakage subset of heterogeneous Gbuffer banks
that covers the input activations and (disjointly) the output activations;
every unselected bank is power-gated during that layer's execution.

The paper formulates this as an ILP.  With ≤ 12 heterogeneous banks the
*exact* optimum is found by enumerating the 3^K {unused, input, output}
assignments with branch-and-bound pruning; for the homogeneous baseline the
optimum has a closed form (banks are fungible).  Both are exact solutions of
the ILP, requiring no external solver.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Bank:
    size_bytes: int
    leakage_w: float


def make_banks(sizes_bytes: Sequence[int], leak_per_kb_w: float, overhead_w: float) -> List[Bank]:
    """CACTI-style leakage model: linear in capacity plus a fixed periphery term."""
    return [
        Bank(size_bytes=s, leakage_w=leak_per_kb_w * (s / 1024.0) + overhead_w)
        for s in sizes_bytes
    ]


@dataclasses.dataclass(frozen=True)
class BankSelection:
    input_banks: Tuple[int, ...]
    output_banks: Tuple[int, ...]
    leakage_w: float
    feasible: bool


def _homogeneous(banks: Sequence[Bank], in_bytes: int, out_bytes: int) -> BankSelection:
    size = banks[0].size_bytes
    leak = banks[0].leakage_w
    n_in = math.ceil(in_bytes / size) if in_bytes else 0
    n_out = math.ceil(out_bytes / size) if out_bytes else 0
    if n_in + n_out > len(banks):
        # Infeasible: activations must be processed in multiple passes; the
        # caller partitions the layer.  Report all banks active.
        return BankSelection(tuple(range(len(banks))), (), leak * len(banks), False)
    return BankSelection(
        tuple(range(n_in)),
        tuple(range(n_in, n_in + n_out)),
        leak * (n_in + n_out),
        True,
    )


def select_banks(banks: Sequence[Bank], in_bytes: int, out_bytes: int) -> BankSelection:
    """Exact minimal-leakage disjoint double cover (the paper's ILP)."""
    if len(set((b.size_bytes, b.leakage_w) for b in banks)) == 1:
        return _homogeneous(banks, in_bytes, out_bytes)

    # Order banks by descending size for stronger bound pruning.
    order = sorted(range(len(banks)), key=lambda i: -banks[i].size_bytes)
    best = {"leak": float("inf"), "in": (), "out": ()}
    suffix_size = [0] * (len(order) + 1)
    for i in range(len(order) - 1, -1, -1):
        suffix_size[i] = suffix_size[i + 1] + banks[order[i]].size_bytes

    def rec(i: int, in_cov: int, out_cov: int, leak: float, ins: tuple, outs: tuple):
        if leak >= best["leak"]:
            return
        if in_cov >= in_bytes and out_cov >= out_bytes:
            best.update({"leak": leak, "in": ins, "out": outs})
            return
        if i == len(order):
            return
        remaining = suffix_size[i]
        if in_cov + out_cov + remaining < in_bytes + out_bytes:
            return  # cannot cover even using every remaining bank
        b = order[i]
        bank = banks[b]
        # Branch: unused / input / output.  Try "used" branches first so the
        # incumbent tightens quickly.
        if in_cov < in_bytes:
            rec(i + 1, in_cov + bank.size_bytes, out_cov, leak + bank.leakage_w,
                ins + (b,), outs)
        if out_cov < out_bytes:
            rec(i + 1, in_cov, out_cov + bank.size_bytes, leak + bank.leakage_w,
                ins, outs + (b,))
        rec(i + 1, in_cov, out_cov, leak, ins, outs)

    rec(0, 0, 0, 0.0, (), ())
    if best["leak"] is float("inf") or best["leak"] == float("inf"):
        return BankSelection(tuple(range(len(banks))), (),
                             sum(b.leakage_w for b in banks), False)
    return BankSelection(tuple(best["in"]), tuple(best["out"]), best["leak"], True)


def total_leakage(banks: Sequence[Bank]) -> float:
    return sum(b.leakage_w for b in banks)
