"""Layer-streaming executor: run a model whose weights do not fit the device
weight arena, overlapping each layer's compute with the delta-encoded
install of upcoming layers (paper Fig 8, DMA edition) — PyTorch port of
`repro.streaming.executor`.

Mechanics:
  * big tensors (ndim ≥ 2) of each block are quantized to uint8 codes in a
    host `QuantizedStore` (with §V-C re-encoding); small tensors (norm
    scales, biases) stay in their dtype and permanently device-resident;
  * a slot's occupant is updated by shipping ``delta = (new − old) mod 256``
    — one byte per weight — computed on the host into a pinned staging
    buffer, copied into a new device buffer and turned into the new codes
    there by the `delta_apply` kernel (the slot's old codes stay readable
    until the layer that used them was computed); the *accounted* wire
    bytes use the 2-bit-cell delta stream (`delta.wire_cost`), and each
    install's programming pulses come from the `pulse_count` kernel
    (`install_log`), both counted on the old and new codes the device
    already holds;
  * installs are issued ahead of use: on a CUDA device the copy, the delta
    apply and the accounting run on a copy stream, and each install
    records an event that its layer's compute waits on — so compute of
    layer i runs while layer i+1 transfers, the double-buffering the
    static `StreamPlan` prescribes;
  * every compute dequantizes the code vector (Eq. 7 zero-point
    compensation folded in) and applies the block.

A block's leaves are ordered as `jax.tree_util.tree_flatten` orders them
(dict keys sorted), so a layer's code vector and its split into quantized
and small tensors are the reference's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.delta_apply.ops import apply_delta
from repro_torch.nn.config import ModelConfig
from repro_torch.nn.layers import rmsnorm, unembed
from repro_torch.nn.model import _inputs_to_x
from repro_torch.nn.transformer import apply_block, stack_plan
from repro_torch.streaming.delta import QuantizedStore, flip_counts, wire_cost
from repro_torch.streaming.plan import (InstallCostModel, LinkModel,
                                        StreamLayer, StreamPlan,
                                        build_stream_plan)
from repro_torch.tree import tree_map

QUANT_MIN_SIZE = 1024  # tensors smaller than this stay device-resident


def _flatten_sorted(tree: Any, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in jax's flatten order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten_sorted(tree[k],
                                                                 path + (k,))]
    return [(path, tree)]


def layer_blocks(params: Any, cfg: ModelConfig) -> List[Dict]:
    """Each layer's block params, scanned segments unstacked into
    individual layers (views of the stacked leaves)."""
    blocks = []
    for seg_params, (start, length, scanned) in zip(
            params["stack"]["segments"], stack_plan(cfg)):
        if scanned:
            blocks.extend(tree_map(lambda a, i=i: a[i], seg_params)
                          for i in range(length))
        else:
            blocks.append(seg_params)
    return blocks


def split_block(bp: Dict) -> Tuple[List[Tuple], List[torch.Tensor],
                                   List[bool]]:
    """(paths, leaves, is_quantized) of a block in jax's flatten order: the
    big tensors (>= 2 dims, >= QUANT_MIN_SIZE elements) are quantized, the
    rest stay in their dtype (the reference's `_split_block_params`)."""
    paths, leaves = zip(*_flatten_sorted(bp))
    flags = [l.ndim >= 2 and l.numel() >= QUANT_MIN_SIZE for l in leaves]
    return list(paths), list(leaves), flags


def _unflatten(paths: List[Tuple], leaves: List[Any]) -> Dict:
    out: Dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


@dataclasses.dataclass
class InstallStats:
    raw_bytes: int = 0
    wire_bytes: int = 0
    installs: int = 0
    skips: float = 0.0
    modeled_s: float = 0.0   # cost-model install time (the latency overlap hides)

    @property
    def mean_skip(self) -> float:
        return self.skips / max(self.installs, 1)


class StreamingExecutor:
    def __init__(self, params: Any, cfg: ModelConfig, *,
                 arena_slots: int = 2, reuse: bool = True,
                 link: LinkModel = LinkModel(), plan_tokens: int = 1,
                 device="cuda"):
        dev = resolve_device(device)
        blocks = layer_blocks(params, cfg)
        self.cfg = cfg
        self.device = dev
        self.n_layers = len(blocks)
        self.arena_slots = arena_slots

        self.paths, self.flags, self.small = [], [], []
        store_input = []
        for i, bp in enumerate(blocks):
            paths, leaves, flags = split_block(bp)
            self.paths.append(paths)
            self.flags.append(flags)
            self.small.append([l.to(dev) for l, f in zip(leaves, flags)
                               if not f])
            store_input.append((f"L{i}", [l for l, f in zip(leaves, flags)
                                          if f]))
        self.store = QuantizedStore(store_input, reuse=reuse, device=dev)

        # resident top-level params
        self.embedding = tree_map(lambda a: a.to(dev), params["embedding"])
        self.final_norm = tree_map(lambda a: a.to(dev), params["final_norm"])

        # plan
        tokens = plan_tokens
        stream_layers = [
            StreamLayer(
                name=f"L{i}",
                bytes_int8=max(int(self.store.layers[i].codes.numel()), 1),
                flops_per_token=2.0 * float(self.store.layers[i].codes.numel()),
                tokens=tokens)
            for i in range(self.n_layers)
        ]
        slot_bytes = max(l.bytes_int8 for l in stream_layers)
        self.cost_model = InstallCostModel.from_link(link)
        self.plan: StreamPlan = build_stream_plan(
            stream_layers, hbm_weight_budget_bytes=arena_slots * slot_bytes,
            link=link, slot_bytes=slot_bytes, replication=False,
            cost_model=self.cost_model)

        # the copy path: a pinned host staging buffer for deltas and a copy
        # stream (CUDA only)
        self._cuda = dev.type == "cuda"
        if self._cuda:
            self._copy_stream = torch.cuda.Stream(dev)
            self._staging = torch.empty(slot_bytes, dtype=torch.uint8,
                                        pin_memory=True)
            self._staged = None      # event: the last copy out of staging
        self.reset()

    def reset(self) -> None:
        """Empty the arena and zero the install accounting (the state of a
        fresh executor over the same store)."""
        # device arena: slot -> (layer_id | None, device uint8 codes)
        self.slots: List[Tuple[Optional[int], Optional[torch.Tensor]]] = [
            (None, None) for _ in range(self.arena_slots)]
        self.layer_slot: Dict[int, int] = {}
        self.stats = InstallStats()
        #: one record per install: kind (cold | delta), layer, resident,
        #: slot, wire bytes, skip, cells programmed, pulses, seconds of host
        #: work on the delta, of accounting (wire cost and flips, waited
        #: for on the host) and of the host-to-device copy
        self.install_log: List[Dict[str, Any]] = []
        self._ready: Dict[int, Any] = {}      # layer -> install-done event

    # ------------------------------------------------------------ install
    def _side(self):
        return (torch.cuda.stream(self._copy_stream) if self._cuda
                else contextlib.nullcontext())

    def _pick_slot(self, layer: int) -> int:
        for s, (occ, _) in enumerate(self.slots):
            if occ is None:
                return s
        # evict the resident layer furthest in the past (lowest id < layer)
        occupants = [(occ, s) for s, (occ, _) in enumerate(self.slots)]
        return min(occupants)[1]

    def install(self, layer: int) -> None:
        if layer in self.layer_slot:
            return
        t0 = time.perf_counter()
        s = self._pick_slot(layer)
        occ, codes_dev = self.slots[s]
        new_codes = self.store.layers[layer].codes
        n = new_codes.numel()
        # a slot holding codes of this size takes a delta, else a full stream
        cold = codes_dev is None or codes_dev.numel() != n
        if not cold:
            # delta = (new − old) mod 256: uint8 subtraction wraps
            old_codes = self.store.layers[occ].codes
            if self._cuda:
                if self._staged is not None:
                    self._staged.synchronize()   # staging is free again
                delta = torch.sub(new_codes, old_codes, out=self._staging[:n])
            else:
                delta = torch.sub(new_codes, old_codes)
        t_host = time.perf_counter() - t0
        compute = torch.cuda.current_stream(self.device) if self._cuda \
            else None
        with self._side():
            t1 = time.perf_counter()
            if self._cuda:
                copy_start = torch.cuda.Event(enable_timing=True)
                copy_end = torch.cuda.Event(enable_timing=True)
                copy_start.record()
            # into a new buffer: the slot's codes may still be read
            buf = (new_codes if cold else delta).to(
                self.device, non_blocking=True, copy=True)
            if self._cuda:
                copy_end.record()
                self._staged = copy_end
                buf.record_stream(compute)  # made here, read by compute
            if not cold:      # the delta becomes the new codes in place
                apply_delta(codes_dev, buf, out=buf)
            if self._cuda:
                self._ready[layer] = torch.cuda.Event()
                self._ready[layer].record()
            t_copy = time.perf_counter() - t1
            t2 = time.perf_counter()
            # accounting on the codes the device holds, on the copy stream:
            # it never waits for compute
            wire, skip = wire_cost(codes_dev, buf)
            cells, pulses = flip_counts(codes_dev, buf)
            t_account = time.perf_counter() - t2
        # (the reference drops the evicted occupant on a delta install only,
        # leaving it mapped to a slot a cold install of another size took)
        self.layer_slot.pop(occ, None)
        self.stats.raw_bytes += n
        self.stats.wire_bytes += wire
        self.stats.installs += 1
        self.stats.skips += skip
        self.stats.modeled_s += self.cost_model.install_s(wire)
        self.slots[s] = (layer, buf)
        self.layer_slot[layer] = s
        self.install_log.append({
            "kind": "cold" if cold else "delta", "layer": layer,
            "resident": occ, "slot": s, "wire_bytes": wire, "skip": skip,
            "cells": cells, "pulses": pulses, "host_s": t_host,
            "account_s": t_account,
            "copy_s": (copy_start, copy_end) if self._cuda else t_copy})

    # ------------------------------------------------------------ compute
    def _block_params(self, layer: int, codes: torch.Tensor) -> Dict:
        """Dequantize the slot's codes ((c − zp)·sc in f32, then bf16) and
        rebuild the block's param dict around the resident small tensors."""
        lw = self.store.layers[layer]
        tensors = []
        off = 0
        for sz, shp, sc, zp in zip(lw.sizes, lw.shapes, lw.scales,
                                   lw.zero_points):
            c = codes[off:off + sz]
            t = (c.to(torch.float32) - float(zp)) * float(sc)
            tensors.append(t.reshape(shp).to(torch.bfloat16))
            off += sz
        big, small = iter(tensors), iter(self.small[layer])
        leaves = [next(big) if f else next(small) for f in self.flags[layer]]
        return _unflatten(self.paths[layer], leaves)

    def _compute(self, layer: int, x: torch.Tensor) -> torch.Tensor:
        s = self.layer_slot[layer]
        if self._cuda:
            torch.cuda.current_stream(self.device).wait_event(
                self._ready[layer])
        bp = self._block_params(layer, self.slots[s][1])
        y, _ = apply_block(bp, x, self.cfg, layer)
        return y.to(torch.bfloat16)    # each layer's output is a bf16 array

    def forward(self, batch: Dict[str, Any], prefetch: int = 1
                ) -> Tuple[torch.Tensor, Dict[str, float]]:
        """Full forward pass following the streaming plan."""
        cfg = self.cfg
        t0 = time.perf_counter()
        x, _ = _inputs_to_x({"embedding": self.embedding}, batch, cfg)
        for i in range(min(prefetch + 1, self.n_layers)):
            self.install(i)
        for i in range(self.n_layers):
            self.install(i)
            x = self._compute(i, x)
            # overlap: kick off upcoming installs while the device computes
            for j in range(i + 1, min(i + 1 + prefetch, self.n_layers)):
                if len(self.layer_slot) < self.arena_slots or j == i + 1:
                    self.install(j)
        x = rmsnorm(self.final_norm, x, cfg.norm_eps)
        logits = unembed(self.embedding, x, cfg)
        if self._cuda:
            torch.cuda.synchronize(self.device)
            for rec in self.install_log:
                if isinstance(rec["copy_s"], tuple):
                    start, end = rec["copy_s"]
                    rec["copy_s"] = start.elapsed_time(end) / 1e3
        wall = time.perf_counter() - t0
        m = {
            "wall_s": wall,
            "raw_bytes": float(self.stats.raw_bytes),
            "wire_bytes": float(self.stats.wire_bytes),
            "mean_skip": self.stats.mean_skip,
            "install_s_model": self.stats.modeled_s,
            "plan_makespan_s": self.plan.makespan_s,
            "plan_serial_s": self.plan.serial_makespan_s,
            "plan_overlap_speedup": self.plan.overlap_speedup,
            "reuse_center": float(self.store.center or 0),
        }
        return logits, m
