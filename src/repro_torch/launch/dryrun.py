"""Multi-pod dry run: count every (architecture × shape × mesh) cell on
`meta` tensors under a fake 256- or 512-rank process group; record memory,
FLOPs, bytes and collective traffic for the roofline report — PyTorch port
of `repro.launch.dryrun`.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # every cell, subprocess each

The reference lowers and compiles each cell on 512 forced host devices and
reads XLA's memory analysis, cost analysis and optimized HLO.  PyTorch has
no compiler to ask, so the port counts:

  * meshes: torch's fake process group (`torch.testing._internal.
    distributed.fake_pg`, imported inside `fake_mesh` only) gives one
    process 512 ranks that move nothing, and `make_production_mesh` its
    (16, 16) or (2, 16, 16) mesh; the group ends with the cell;
  * per-device argument and output bytes: each leaf's `meta` shape split
    by its placements under the sharding trees, an uneven split rounded
    up as DTensor rounds it; alias bytes follow the reference's donated
    arguments (params and optimizer state in training, caches in decode);
  * FLOPs and bytes: the cell's step run once on `meta` tensors at full
    depth, FLOPs by `FlopCounterMode`, bytes as the sum of every aten op's
    input and output bytes (views and empty allocations move none) —
    eager PyTorch's unfused count, not a fused program's — plus the
    attention kernels' tallies (their `meta` routes count by formula).  A
    training cell that the step splits (`launch.steps.split_shardings`:
    the dense GQA and the MoE families, where every leaf places evenly on
    the mesh) runs rank 0's split step under the fake mesh: its blocks of
    the params and moments, its block of the batch, its heads, ff, experts
    and vocab, its tokens routed through the all-to-all body at the
    config's capacity, so the count is rank 0's per-device count as it
    is.  Every other cell runs the whole step over the global batch,
    divided by the chip count (the split the sharding trees describe;
    those layers do not split themselves).  Without a mesh the port's MoE
    layer evaluates every expert over every token, and so does this
    count;
  * temp bytes: the peak of live bytes the step allocates (outputs
    aside): rank 0's in a split cell, else over the chip count;
  * collectives: a split cell's are the ones its step issues, each
    recorded as rank 0 runs it (`parallel.collectives`): the sequence
    gathers and scatters over `model` around attention, the MLP, the
    embedding and the loss, the FSDP gathers over `data` and their
    gradients' reduce-scatters, the loss's reductions over `model`, the
    gradients' all-reduces over the axes a leaf is not split over and the
    global norm's, and in the MoE layers the all-to-alls over `model` and
    the expert stacks' gathers over `data`.  In every other cell: one MoE
    layer run on `meta` under
    the fake mesh as rank 0 records its all-to-alls, gathers and
    all-reduces (forward, and in training the remat's second forward and
    the backward), times the MoE layers; plus the parameter traffic the
    placements imply: an all-gather over `data` of each FSDP-split leaf
    for each use (forward, and the remat's recompute in training) and in
    training each leaf's gradient reduced over the batch axes (a
    reduce-scatter over `data` for a split leaf, else an all-reduce; an
    all-reduce over `pod`).  Not counted there: tensor-parallel activation
    reductions, which those layers do not issue, and `_Replicated`'s
    gradient sums, which stand in for them.

Counting on `meta` compiles nothing, so there are no depth probes:
`probe` is the full-depth count with `probe_depths` (n_layers,).
"""
import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, get_config, supported_shapes
from repro_torch.data.pipeline import DataConfig, make_batch_specs
from repro_torch.kernels import counting
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import SHAPES, ShapeSpec
from repro_torch.launch.steps import (
    abstract_caches,
    abstract_opt_state,
    abstract_params,
    batch_axis_for,
    batch_shardings,
    cache_shardings,
    cached_prefill_step,
    cached_serve_step,
    make_train_step,
    opt_shardings,
    param_shardings,
    split_shardings,
)
from repro_torch.nn.attention import head_plan
from repro_torch.nn.moe import moe
from repro_torch.parallel.collectives import recording_collectives
from repro_torch.parallel.sharding import (NamedSharding, PartitionSpec as P,
                                           axis_size, local_shape,
                                           make_spec, place, use_mesh,
                                           whole_shape)
from repro_torch.roofline.analysis import (HW, collective_bytes_from_records,
                                           roofline_terms)
from repro_torch.tree import tree_flatten, tree_map

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

FAKE_WORLD = 512
COUNT = "meta, unfused"
# what the cells whose layers do not split leave out of their collective
# term (a split cell records every collective its step issues)
NOT_COUNTED = ("tensor-parallel activation reductions (these layers issue "
               "none)", "_Replicated's gradient sums over the mesh")

# aten ops that move no bytes and are not views by their schema:
# allocations left empty, and the alias `reshape` makes of a fresh copy
_NO_TRAFFIC = {
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
    torch.ops.aten.empty_strided.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default,
    torch.ops.aten._unsafe_view.default,
}


def _model_flops(cfg, spec: ShapeSpec) -> float:
    n_active = cfg.active_param_count()
    if spec.kind == "train":
        return 6.0 * n_active * spec.seq_len * spec.global_batch
    if spec.kind == "prefill":
        return 2.0 * n_active * spec.seq_len * spec.global_batch
    return 2.0 * n_active * spec.global_batch  # decode: one token per seq


@contextlib.contextmanager
def fake_mesh(multi_pod: bool):
    """The production mesh over a fake 512-rank default group, this
    process rank 0, for the body of the `with`; the group is destroyed
    after it.  Raises if a process group already exists: the dry run
    neither reuses nor ends a group it did not start."""
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group; "
                           "one is already initialized")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=FAKE_WORLD)
    try:
        yield make_production_mesh(multi_pod=multi_pod, device="cpu")
    finally:
        dist.destroy_process_group()


class Traffic(TorchDispatchMode):
    """Every aten op's input and output bytes (`bytes`, views and empty
    allocations aside), and the peak of live bytes of the tensors the ops
    allocate (`peak`; a weakref finalizer per output frees its bytes)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func in _NO_TRAFFIC:
            return out
        ins = [t for t in _pytree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in _pytree_leaves(out) if isinstance(t, torch.Tensor)]
        self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            if not any(t is i for i in ins):     # in place: not a new tensor
                n = _nbytes(t)
                self.live += n
                weakref.finalize(t, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@contextlib.contextmanager
def counting_step():
    """FLOPs, bytes and peak live bytes of what runs in the body of the
    `with`, on any device: the aten ops' through `FlopCounterMode` and
    `Traffic`, the attention kernels' through their tallies.  Yields a
    dict filled in when the body ends."""
    result = {}
    traffic = Traffic()
    with counting() as tally, FlopCounterMode(display=False) as flops, \
            traffic:
        yield result
    result.update(flops=flops.get_total_flops() + tally["flops"],
                  bytes=traffic.bytes + tally["bytes"], peak=traffic.peak,
                  kernels={k: v for k, v in tally.items()
                           if k not in ("flops", "bytes")})


# ------------------------------------------------------ per-device bytes
def _pairs(values, shardings, path=()):
    """(path, leaf, NamedSharding) over a value tree and its sharding tree."""
    if isinstance(shardings, NamedSharding):
        if values is not None:
            yield path, values, shardings
    elif isinstance(shardings, dict):
        for k in shardings:
            yield from _pairs(values[k], shardings[k], path + (k,))
    elif isinstance(shardings, (list, tuple)):
        for i, (v, s) in enumerate(zip(values, shardings)):
            yield from _pairs(v, s, path + (i,))
    elif dataclasses.is_dataclass(shardings):
        for f in dataclasses.fields(shardings):
            yield from _pairs(getattr(values, f.name),
                              getattr(shardings, f.name), path + (f.name,))


def local_bytes(values, shardings) -> int:
    return sum(math.prod(local_shape(t.shape, s)) * t.element_size()
               for _, t, s in _pairs(values, shardings))


# ------------------------------------------------------------ the step
def _cell_inputs(cfg, spec: ShapeSpec, mesh):
    """(step, its meta arguments, their shardings, donated argument
    indices, output shardings as a function of the outputs) of the cell,
    the shardings built under the mesh."""
    psh = param_shardings(cfg, mesh)
    aparams = abstract_params(cfg)
    rep = NamedSharding(mesh, P())
    if spec.kind == "train":
        aopt = abstract_opt_state(aparams)
        osh = opt_shardings(psh, mesh)
        abatch = make_batch_specs(cfg, DataConfig(spec.seq_len,
                                                  spec.global_batch))
        args = (aparams, aopt, abatch, 1)
        shardings = (psh, osh, batch_shardings(cfg, mesh), None)
        return (make_train_step(cfg), args, shardings, (0, 1),
                lambda out: (psh, osh, _replicated(out[2], rep)))
    if spec.kind == "prefill":
        abatch = make_batch_specs(cfg, DataConfig(spec.seq_len,
                                                  spec.global_batch))
        fn = cached_prefill_step(cfg, spec.seq_len + cfg.prefix_len)
        csh = cache_shardings(cfg, mesh, spec.global_batch)
        lsh = NamedSharding(mesh, P(batch_axis_for(mesh, spec.global_batch)))
        return (fn, (aparams, abatch), (psh, batch_shardings(cfg, mesh)), (),
                lambda out: (lsh, csh))
    acaches = abstract_caches(cfg, spec.global_batch, spec.seq_len)
    csh = cache_shardings(cfg, mesh, spec.global_batch)
    bsh = NamedSharding(mesh, P(batch_axis_for(mesh, spec.global_batch)))
    atoken = torch.empty((spec.global_batch,), dtype=torch.int32,
                         device="meta")
    apos = torch.empty((), dtype=torch.int32, device="meta")
    return (cached_serve_step(cfg), (aparams, atoken, acaches, apos),
            (psh, bsh, csh, rep), (2,), lambda out: (bsh, csh))


def _replicated(tree, rep):
    """A metrics dict's shardings: every tensor replicated."""
    if isinstance(tree, dict):
        return {k: _replicated(v, rep) for k, v in tree.items()}
    return rep if isinstance(tree, torch.Tensor) else None


def count_step(fn, args, train: bool):
    """Run the step once on its arguments (`meta` tensors, or tensors on
    a card) under `counting_step`: (outputs, counts, wall seconds)."""
    t0 = time.perf_counter()
    grad = contextlib.nullcontext() if train else torch.no_grad()
    with grad, counting_step() as counts:
        out = fn(*args)
    return out, counts, time.perf_counter() - t0


def _leaves(tree):
    return [t for t in tree_flatten(tree) if isinstance(t, torch.Tensor)]


# --------------------------------------------------------- collectives
def _moe_layer(aparams):
    """The first MoE layer's params (one layer of a scanned segment)."""
    layer = next(seg["moe"] for seg in aparams["stack"]["segments"]
                 if "moe" in seg)
    if layer["router"].dim() == 3:                 # stacked over layers
        layer = tree_map(lambda w: w[0], layer)
    return layer


def moe_records(cfg, spec: ShapeSpec, aparams, mesh):
    """Collective records of every MoE layer of the step, from one layer
    run on `meta` under the mesh as rank 0: its forward (twice in
    training: the remat recomputes it) and in training its backward, times
    the MoE layers.  [] without MoE layers, or when the batch does not
    split over the mesh's batch axes (`note` says so)."""
    n_moe = sum(cfg.layer_is_moe)
    if not n_moe:
        return [], None
    decode = spec.kind == "decode"
    with use_mesh(mesh):
        ba = make_spec("batch")[0]
        n_b = math.prod(axis_size(mesh, a)
                        for a in ((ba,) if isinstance(ba, str) else ba))
        seq = 1 if decode else spec.seq_len
        model = axis_size(mesh, "model")
        if (spec.global_batch % n_b or (not decode and seq % model)
                or cfg.n_experts % model):
            return [], (f"batch {spec.global_batch} x {seq} or "
                        f"{cfg.n_experts} experts do not split over the "
                        f"mesh: MoE collectives not counted")
        train = spec.kind == "train"
        layer = tree_map(lambda w: w.detach().requires_grad_(train),
                         _moe_layer(aparams))
        x = torch.empty((spec.global_batch, seq, cfg.d_model),
                        dtype=torch.bfloat16, device="meta",
                        requires_grad=train)
        grad = torch.enable_grad() if train else torch.no_grad()
        with grad, recording_collectives() as fwd:
            y, aux = moe(layer, x, cfg, decode=decode)
        bwd = []
        if train:
            leaves = [x] + _leaves(layer)
            with recording_collectives() as bwd:
                torch.autograd.grad(y.float().sum() + aux, leaves,
                                    allow_unused=True)
    per_layer = fwd * (2 if train else 1) + bwd
    return per_layer * n_moe, None


def _is_expert_leaf(path) -> bool:
    return "moe" in path and path[-1] in ("w_gate", "w_up", "w_down")


def param_records(aparams, psh, mesh, train: bool):
    """The parameter traffic the placements imply (see the module
    docstring); the MoE expert stacks aside, whose gathers the MoE bodies
    issue and record themselves."""
    names = tuple(mesh.mesh_dim_names)
    sizes = {n: mesh.size(i) for i, n in enumerate(names)}
    out = []
    for path, t, sh in _pairs(aparams, psh):
        if _is_expert_leaf(path):
            continue
        local = math.prod(local_shape(t.shape, sh)) * t.element_size()
        split_data = any(e == "data" or (isinstance(e, tuple) and "data" in e)
                         for e in sh.spec)
        if split_data:
            out += [("all-gather", local * sizes["data"], sizes["data"])] * (
                2 if train else 1)
        if train:
            out.append(("reduce-scatter", local, sizes["data"]) if split_data
                       else ("all-reduce", local, sizes["data"]))
            if "pod" in sizes:
                out.append(("all-reduce", local, sizes["pod"]))
    return out


# ------------------------------------------------------ a split step
def split_count(fn, args, shardings, mesh):
    """Rank 0's split training step on `meta` under the fake mesh: its
    blocks of the whole abstract params and moments (`place`), the global
    batch (the step takes its block).  (its arguments, outputs, counts,
    wall seconds, the collectives it issued)."""
    with use_mesh(mesh):
        local = (place(args[0], shardings[0]), place(args[1], shardings[1]),
                 *args[2:])
        with recording_collectives() as records:
            out, counts, secs = count_step(fn, local, train=True)
    return local, out, counts, secs, records


def places_evenly(values, shardings) -> bool:
    """Whether every leaf's dims divide over the mesh axes its sharding
    splits them over (`place` raises where one does not)."""
    return all(whole_shape(local_shape(t.shape, sh), sh) == tuple(t.shape)
               for _, t, sh in _pairs(values, shardings))


def split_layout(cfg, mesh) -> dict:
    """How rank 0 of a split cell divides attention: whole query heads
    over `model`, or every head on each model rank where they do not
    divide (`nn.attention.head_plan`); and a MoE config's experts a
    rank."""
    model = axis_size(mesh, "model")
    plan = head_plan(cfg.n_heads, cfg.n_kv_heads, model, 0)
    return {
        "experts_per_rank": (cfg.n_experts // model if cfg.n_experts
                             else None),
        "rank": 0, "model": model,
        "attention": ("every head on each model rank (the query heads do "
                      "not divide over model; the attention weights' model "
                      "blocks are gathered)" if plan is None else
                      "query heads split over model"),
        "q_heads_per_rank": cfg.n_heads if plan is None else plan[1],
        "kv_heads_per_rank": (cfg.n_kv_heads if plan is None
                              else len(set(plan[2]))),
    }


# ---------------------------------------------------------------- a cell
def run_cell(arch: str, shape_name: str, multi_pod: bool,
             smoke: bool = False, skip_probes: bool = False,
             kv_int8: bool = False) -> dict:
    cfg = get_config(arch, smoke=smoke)
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    spec = SHAPES[shape_name]
    if smoke:
        spec = dataclasses.replace(spec, seq_len=min(spec.seq_len, 128),
                                   global_batch=min(spec.global_batch, 16))
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    with fake_mesh(multi_pod) as mesh:
        chips = mesh.size()
        with use_mesh(mesh):
            fn, args, shardings, donated, out_sh = _cell_inputs(cfg, spec,
                                                                mesh)
        aparams = args[0]
        split = (spec.kind == "train"
                 and split_shardings(cfg, mesh) is not None
                 and places_evenly(aparams, shardings[0]))
        if split:
            local_args, out, counts, t_lower, records = split_count(
                fn, args, shardings, mesh)
            note, per = None, 1
            split_d = split_layout(cfg, mesh)
        else:
            records, note = moe_records(cfg, spec, aparams, mesh)
            records += param_records(aparams, shardings[0], mesh,
                                     spec.kind == "train")
            per, split_d = chips, None
    coll = collective_bytes_from_records(records, default_group=chips)

    if not split:
        out, counts, t_lower = count_step(fn, args, spec.kind == "train")
    args_b = sum(local_bytes(a, s) for a, s in zip(args, shardings)
                 if s is not None)
    # a split step returns its blocks: price the outputs by the whole
    # leaves they are blocks of (the donated params and moments)
    out_b = local_bytes((args[0], args[1], out[2]) if split else out,
                        out_sh(out))
    alias_b = sum(local_bytes(args[i], shardings[i]) for i in donated)
    in_ids = {id(t) for t in _leaves(local_args if split else args)}
    new_out = sum(_nbytes(t) for t in _leaves(out) if id(t) not in in_ids)
    temp_b = max(counts["peak"] - new_out, 0) // per
    mem_d = {"argument_size_in_bytes": args_b,
             "output_size_in_bytes": out_b,
             "temp_size_in_bytes": temp_b,
             "generated_code_size_in_bytes": None,
             "alias_size_in_bytes": alias_b}

    probe = None
    if not multi_pod and not skip_probes:
        probe = {"flops": counts["flops"] / per,
                 "bytes": counts["bytes"] / per, "coll": coll["total"],
                 "probe_depths": (cfg.n_layers,)}
    report = None
    if probe is not None:
        report = roofline_terms(
            arch=arch, shape=shape_name, mesh_name=mesh_name, chips=chips,
            cost_analysis={"flops": probe["flops"],
                           "bytes accessed": probe["bytes"]},
            hlo_text="",
            model_flops_global=_model_flops(cfg, spec))
        report.collective_bytes_per_device = probe["coll"]
        report.collective_s = probe["coll"] / HW["link_bw"]
        terms = {"compute": report.compute_s, "memory": report.memory_s,
                 "collective": report.collective_s}
        report.dominant = max(terms, key=terms.get)
        report.collectives = coll

    per_device_bytes = args_b + temp_b + out_b - alias_b
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "chips": chips, "smoke": smoke,
        "lower_s": round(t_lower, 1), "compile_s": 0.0,
        "memory_analysis": mem_d,
        "per_device_bytes": per_device_bytes,
        "per_device_gb": round(per_device_bytes / 1024**3, 3),
        "fits_hbm": bool(per_device_bytes <= HW["hbm_bytes"]),
        "collective_ops_full_hlo": {k: v for k, v in coll.items()
                                    if k.startswith("n_")},
        "probe": probe,
        "roofline": report.as_dict() if report else None,
        "count": COUNT,
        "collectives_not_counted": [] if split else (
            list(NOT_COUNTED) + ([note] if note else [])),
        "kernel_calls": counts["kernels"],
        "dense_split": split_d,
        "collectives_by_axis": None if not split else {
            axis: collective_bytes_from_records(
                [r for r in records if r.axis == axis], default_group=chips)
            for axis in mesh.mesh_dim_names},
    }


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ARCHS)
    p.add_argument("--shape", choices=tuple(SHAPES))
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--all", action="store_true")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--skip-probes", action="store_true")
    p.add_argument("--kv-int8", action="store_true",
                   help="int8 KV cache")
    p.add_argument("--out", default=None)
    p.add_argument("--timeout", type=int, default=5400)
    args = p.parse_args()

    if args.all:
        os.makedirs(RESULTS_DIR, exist_ok=True)
        failures = []
        for arch in ARCHS:
            for shape in supported_shapes(arch):
                for mp in (False, True):
                    mesh_name = "pod2x16x16" if mp else "pod16x16"
                    out = os.path.join(
                        RESULTS_DIR, f"{arch}__{shape}__{mesh_name}.json")
                    if os.path.exists(out):
                        print(f"skip (exists): {out}", flush=True)
                        continue
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape, "--out", out]
                    if mp:
                        cmd.append("--multi-pod")
                    if args.smoke:
                        cmd.append("--smoke")
                    print(f"=== {arch} × {shape} × {mesh_name}", flush=True)
                    t0 = time.time()
                    try:
                        subprocess.run(cmd, check=True, timeout=args.timeout,
                                       stdout=subprocess.DEVNULL)
                        print(f"    ok in {time.time()-t0:.0f}s", flush=True)
                    except Exception as e:  # noqa: BLE001
                        failures.append((arch, shape, mesh_name, repr(e)))
                        print(f"    FAILED after {time.time()-t0:.0f}s: {e}",
                              flush=True)
        print(f"\ndone; {len(failures)} failures")
        for f in failures:
            print("  FAIL:", *f)
        sys.exit(1 if failures else 0)

    assert args.arch and args.shape, "--arch/--shape required (or --all)"
    try:
        result = run_cell(args.arch, args.shape, args.multi_pod, args.smoke,
                          args.skip_probes, args.kv_int8)
    except Exception:
        traceback.print_exc()
        sys.exit(2)
    blob = json.dumps(result, indent=2, default=str)
    print(blob)
    if args.out:
        with open(args.out, "w") as f:
            f.write(blob)


if __name__ == "__main__":
    main()
