"""The split training step over the cards of one machine, one NCCL rank
a card, dense and MoE, held against one-card steps (`chip_smoke.py` runs
the split step on one rank only).

    python3 mesh_probe.py                 # every card, every case
    python3 mesh_probe.py --cases moe     # the MoE cases alone
    python3 mesh_probe.py --ranks 2
    python3 mesh_probe.py --ranks 1       # one card: (1, 1)
    python3 mesh_probe.py --cpu --ranks 4  # smoke configs, gloo, S 64

The cases, each with its params drawn from one seed on every rank (the
reference trainer's dtypes) and the same B 4 x S 2,048 batch:

  * minicpm-2b at full width (36 query heads, one KV head each), on the
    meshes (n/2, 2), (1, n) and (n, 1);
  * minicpm-2b cut to 8 layers with 6 query heads over 3 KV heads, on
    (n/2, 2) and (1, n): under `model` 2 a rank's 3 query heads read two
    KV heads, each repeated on the ranks that read it; under `model` 4 the
    query heads do not divide, so every model rank computes every head
    (`nn.attention.head_plan`);
  * deepseek-v2-lite-16b at full width cut to 4 layers (its dense layer
    and 3 MoE layers), the capacity factor at ceil(n_experts / moe_topk)
    so that no token drops on any block and the aux loss out of the loss
    (a function of the origin rank's block, not of the batch), on (n/2,
    2), (1, n) and (n, 1);
  * deepseek-v2-lite-16b whole (27 layers: [dense, scan·26]) on the same
    meshes, at its own capacity factor: no card holds its whole state
    (~190 GB), so its params are drawn on the card, kept on the host and
    each mesh's blocks cut there;
  * qwen3-moe-235b-a22b at full width cut to 2 layers, on (n/2, 2) and
    (1, n).

For the dense cases rank 0 first runs, alone on its card, the no-mesh
step (twice, for its wall) and, for d 2 and 4, the no-mesh step computed
in d batch blocks: each block's loss over d, its gradient taken alone,
the d gradients summed in their dtype in block order (`blocks<d>`, as a
(d, 1) mesh's reduce-scatters sum them, its FSDP gathers exact) or in
f32, rounded once (`blocks<d>_f32`), then AdamW.  Their params and
moments are kept on the host, and each blocked state is held against the
whole step's by the measures below, with the leaves that part most
named.  For the 4-layer deepseek case rank 0 runs the no-mesh step and
the one-card split step on a 1 x 1 mesh (twice each); the split step
decides, as it runs the same expert-parallel MoE body (each expert's
output rounded to bf16, a token's picks summed in pick order) on the
whole batch, where the no-mesh MoE layer sums every expert in f32 in
expert order, and with no drops each token's function is the body's on
any mesh; the no-mesh step is reported beside it.  The whole deepseek
and the qwen3-moe cases have no one-card step: their walls, peak memory,
bytes held a card and losses are reported.  On one rank the meshes are
(1, 1) alone.  Then every rank runs the split step
(`launch.steps.make_train_step` under `use_mesh`, params and moments
placed into the rank's blocks) on each mesh, each from a fresh
placement, twice (the first one warms the collectives); after the second,
the params and moments are gathered whole leaf by leaf and held against
rank 0's one-card steps, by the measures of
`tests/test_torch_dense_mesh.py`:

  * loss and ce within 3e-4 relative, the grad norm within 2e-2;
  * mu and |g| = sqrt(nu / 0.05): each leaf's least-squares factor to the
    one-card leaf within 2e-2 of 1 (a share missing or counted twice, or
    rows of the wrong batch block, move the embedding table's far from
    it) and the relative norm of the difference over the whole state
    within 2e-2;
  * the params within a bf16 ulp where both first moments clear 1e-6 with
    one sign, on 99% of the elements whose one-card moment clears it, and
    within 2 lr everywhere.

Prints the cards' names and power limits, one JSON line a rank, case and
mesh (walls, peak memory, bytes held, launches, and on rank 0 the state
measures against each reference), then the summary, and exits non-zero
when a mesh step misses its one-card step's measures, a loss is not
finite, or a step launches the flash kernel other than twice a layer.
The process group is started on `tcp://localhost` at a free port and
ended by every rank; a collective that waits five minutes fails the run.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import math
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

ARCH = "minicpm-2b"
B, S = 4, 2048
LR = 1e-5                  # chip_smoke.FALL_LR: warmup 1, step 1
F32_TOL, BF16_TOL = 3e-4, 2e-2
BLOCKS = (2, 4)            # the batch's blocks under data 2 and 4
SIGN_FLOOR, HELD_SHARE = 1e-6, 0.99


def cases(n: int, group: str = "all"):
    """The cases for n ranks, those of `group` ("dense", "moe" or "all"):
    each a dict of its name, arch, config overrides, meshes, and whether
    rank 0 holds it against its one-card no-mesh step (`reference`), also
    in batch blocks (`blocks`), and against its one-card split step on a
    1 x 1 mesh, which then decides (`split_reference`); whether it runs
    with the capacity raised so that no token drops and the aux loss out
    of the loss (`no_drop`), or keeps its whole params on the host
    (`host`: a model whose whole state fits no card)."""
    half = [(n // 2, 2)] if n % 2 == 0 and n > 2 else []
    many = [(1, n), (n, 1)] if n > 1 else [(1, 1)]
    out = [
        dict(name="minicpm-2b", arch="minicpm-2b", replace={},
             meshes=half + many, reference=True, blocks=True, group="dense"),
        dict(name="minicpm-2b-h6kv3", arch="minicpm-2b",
             replace=dict(name="minicpm-2b-h6kv3", n_heads=6, n_kv_heads=3,
                          n_layers=8),
             meshes=half + many[:1], reference=True, blocks=True,
             group="dense"),
        dict(name="deepseek-v2-lite-16b@4", arch="deepseek-v2-lite-16b",
             replace=dict(n_layers=4), meshes=half + many, reference=True,
             no_drop=True, split_reference=True, group="moe"),
        dict(name="deepseek-v2-lite-16b", arch="deepseek-v2-lite-16b",
             replace={}, meshes=half + many, host=True, group="moe"),
        dict(name="qwen3-moe-235b-a22b@2", arch="qwen3-moe-235b-a22b",
             replace=dict(n_layers=2), meshes=half + many[:1],
             group="moe"),
    ]
    return [c for c in out if group in ("all", c["group"])]


def case_config(case, cpu: bool):
    """A case's config: its arch's (smoke on the CPU), its overrides, and
    for `no_drop` a capacity factor of ceil(n_experts / moe_topk), so
    every expert has room for every token of a block, and
    router_aux_weight 0 (the aux is the origin rank's block's, not the
    batch's)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(case["arch"], smoke=cpu),
                              **case["replace"])
    if case.get("no_drop"):
        cfg = dataclasses.replace(
            cfg, capacity_factor=float(math.ceil(cfg.n_experts
                                                 / cfg.moe_topk)),
            router_aux_weight=0.0)
    return cfg


def _paths(tree, pre=""):
    """Leaf names in `tree_flatten` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k],
                                                        f"{pre}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _paths(v,
                                                             f"{pre}/{i}")]
    return [pre or "/"]


def _step(torch, step_fn, params, opt, batch):
    card = batch["tokens"].is_cuda
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = step_fn(params, opt, batch, 1)[2]
    metrics = {k: float(v) for k, v in m.items()}
    wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30 if card else None
    return dict(metrics, wall_ms=wall, peak_gib=peak)


def _blocked_step(torch, cfg, params, opt, batch, d, lr, f32=False):
    """The no-mesh step in d batch blocks (see the module docstring)."""
    from repro_torch.nn.model import lm_loss
    from repro_torch.optim import adamw_update
    from repro_torch.tree import tree_flatten, tree_unflatten
    leaves = tree_flatten(params)
    rows = batch["tokens"].shape[0] // d
    grads, loss, ce = None, 0.0, 0.0
    for t in leaves:
        t.requires_grad_(True)
    try:
        for i in range(d):
            blk = {k: v.narrow(0, i * rows, rows) for k, v in batch.items()}
            with torch.enable_grad():
                l, m = lm_loss(params, blk, cfg)
                g = torch.autograd.grad(l / d, leaves, allow_unused=True)
            g = [torch.zeros_like(t) if x is None else x
                 for t, x in zip(leaves, g)]
            if f32:
                g = [x.float() for x in g]
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            loss += float(l) / d
            ce += float(m["ce"]) / d
    finally:
        for t in leaves:
            t.requires_grad_(False)
    grads = [g.to(t.dtype) for g, t in zip(grads, leaves)]
    _, _, om = adamw_update(params, tree_unflatten(params, grads), opt, lr)
    return {"loss": loss, "ce": ce, "grad_norm": float(om["grad_norm"])}


def _host_state(torch, params, opt):
    from repro_torch.tree import tree_flatten
    return {"p": [t.cpu() for t in tree_flatten(params)],
            "mu": [t.cpu() for t in tree_flatten(opt.mu)],
            "nu": [t.cpu() for t in tree_flatten(opt.nu)]}


def _compare(torch, get, ref, p0, names=None):
    """The state measures of a state against a reference one, leaf by
    leaf: `get(i)` gives leaf i's (param, mu, nu) on the card, `ref` the
    reference's leaf lists 'p', 'mu', 'nu' on the host.  With leaf
    `names`, also the three leaves whose |g| parts most from the
    reference's (least-squares factor, relative norm, elements)."""
    sums = {"mu": [0.0, 0.0, 1.0], "nu": [0.0, 0.0, 1.0]}
    per_leaf = []
    held = eligible = off_ulp = over = 0
    for i, a0 in enumerate(p0):
        got, mu, nu = get(i)
        for name, g in (("mu", mu), ("nu", nu)):
            w = ref[name][i].to(g.device)
            if name == "nu":             # |g|: nu is 0.05 g^2
                g, w = g.sqrt(), w.sqrt()
            g, w = g.double().flatten(), w.double().flatten()
            scale = float(torch.vdot(g, w)
                          / torch.clamp_min(torch.vdot(w, w), 1e-30))
            e, n = float(torch.sum((g - w) ** 2)), float(torch.sum(w ** 2))
            acc = sums[name]
            acc[0], acc[1] = acc[0] + e, acc[1] + n
            if abs(scale - 1) > abs(acc[2] - 1):
                acc[2] = scale
            del g, w
        per_leaf.append((scale, (e / max(n, 1e-300)) ** 0.5, nu.numel()))
        w, m, a0 = (ref["p"][i].to(got.device).float(),
                    ref["mu"][i].to(got.device), a0.to(got.device).float())
        got = got.float()
        clear = m.abs() > SIGN_FLOOR
        sure = clear & (mu.sign() == m.sign()) & (mu.abs() > SIGN_FLOOR)
        ulp = torch.maximum(a0.abs(), w.abs()) * 2.0 ** -7 + 1e-3 * LR
        diff = (got - w).abs()
        off_ulp += int((sure & (diff > ulp)).sum())
        over += int((diff > 2 * LR + ulp).sum())
        held += int(sure.sum())
        eligible += int(clear.sum())
        del got, mu, nu, w, m, a0, clear, sure, ulp, diff
    out = {}
    for name, key in (("mu", "mu"), ("nu", "g")):
        num, den, worst = sums[name]
        out[f"{key}_worst_lsq_factor"] = worst
        out[f"{key}_rel_norm"] = (num / den) ** 0.5
    if names is not None:
        top = sorted(range(len(per_leaf)),
                     key=lambda i: -abs(per_leaf[i][0] - 1))[:3]
        out["g_worst_leaves"] = [[names[i], *per_leaf[i]] for i in top]
    out.update(params_sure=held, params_eligible=eligible,
               params_sure_off_ulp=off_ulp, params_over_2lr=over)
    out["ok"] = bool(
        abs(out["mu_worst_lsq_factor"] - 1) <= BF16_TOL
        and abs(out["g_worst_lsq_factor"] - 1) <= BF16_TOL
        and out["mu_rel_norm"] <= BF16_TOL and out["g_rel_norm"] <= BF16_TOL
        and off_ulp == 0 and over == 0 and held >= HELD_SHARE * eligible)
    return out


def _held_gib(torch, tree) -> float:
    from repro_torch.tree import tree_flatten
    return sum(t.numel() * t.element_size()
               for t in tree_flatten(tree)) / 2**30


def _references(torch, cfg, case, params0, batch, step_fn, free):
    """Rank 0, alone on its card: the no-mesh step (twice, for its wall)
    and for a case with `blocks` the blocked steps (see the module
    docstring).  (the JSON line, {name: (metrics, host state)}, the
    initial params on the host)."""
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_flatten, tree_map
    dev = batch["tokens"].device
    refs, runs = {}, []
    for i in range(2):
        p = tree_map(torch.clone, params0)
        opt = adamw_init(p)
        runs.append(_step(torch, step_fn, p, opt, batch))
        if i == 0:
            refs["whole"] = (runs[0], _host_state(torch, p, opt))
        del p, opt
        free()
    line = {"rank": 0, "case": case["name"], "mesh": None, "runs": runs}
    p0 = [t.cpu() for t in tree_flatten(params0)]
    names = _paths(params0)
    for d in BLOCKS if case.get("blocks") else ():
        for f32 in (False, True):
            key = f"blocks{d}" + ("_f32" if f32 else "")
            p = tree_map(torch.clone, params0)
            opt = adamw_init(p)
            m = _blocked_step(torch, cfg, p, opt, batch, d, runs[0]["lr"],
                              f32)
            state = _host_state(torch, p, opt)
            del p, opt
            free()
            m["vs_whole"] = _compare(
                torch, lambda j: tuple(state[k][j].to(dev) for k in state),
                refs["whole"][1], p0, names)
            line[key] = m
            if not f32 and any(x[0] == d for x in case["meshes"]):
                refs[key] = (m, state)
            del state
            free()
    return line, refs, p0


def worker(rank: int, world: int, port: int, out_path: str,
           cpu: bool = False, group: str = "all") -> None:
    import torch
    import torch.distributed as dist
    import repro_torch.serving  # noqa: F401  (before launch.steps)
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import make_train_step, split_shardings
    from repro_torch.launch.train import cast_for_training
    from repro_torch.nn.model import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import (flat_shardings, gather_whole,
                                               place, use_mesh)
    from repro_torch.tree import tree_flatten, tree_map

    dev = "cpu" if cpu else "cuda"
    if cpu:
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    free = torch.cuda.empty_cache if not cpu else (lambda: None)
    # a collective that waits five minutes fails instead of hanging
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    lines = []
    try:
        for case in cases(world, group):
            name, meshes = case["name"], case["meshes"]
            cfg = case_config(case, cpu)
            t0 = time.perf_counter()
            params0 = cast_for_training(init_params(cfg, seed=0, device=dev))
            if case.get("host"):
                # the whole params wait on the host; each mesh's blocks
                # are cut there and moved to the card
                params0 = tree_map(lambda t: t.cpu(), params0)
                free()
            init_s = time.perf_counter() - t0
            seq = 64 if cpu else S
            batch = {k: torch.as_tensor(v, device=dev) for k, v in
                     make_batch(cfg, DataConfig(seq_len=seq, global_batch=B),
                                0).items()}
            step_fn = make_train_step(cfg, peak_lr=LR, warmup=1)
            refs, p0 = {}, None
            if rank == 0 and case.get("reference"):
                line, refs, p0 = _references(torch, cfg, case, params0,
                                             batch, step_fn, free)
                lines.append(line)
            if case.get("split_reference"):
                # every rank builds the 1 x 1 mesh's groups; rank 0 steps
                mesh = make_debug_mesh(1, 1, device=dev)
                if rank == 0:
                    with use_mesh(mesh):
                        sh = split_shardings(cfg, mesh)
                        runs = []
                        for i in range(2):
                            p = place(params0, sh["params"])
                            opt = adamw_init(p)
                            runs.append(_step(torch, step_fn, p, opt, batch))
                            if i == 0:
                                refs["one_card_split"] = (
                                    runs[0], _host_state(torch, p, opt))
                            del p, opt
                            free()
                    line["one_card_split_runs"] = runs
            box = [{k: v[0] for k, v in refs.items()}]
            dist.broadcast_object_list(box, src=0)
            # the reference that decides: the one-card split step where
            # the case has one (the same MoE body as every mesh's), else
            # the no-mesh step
            gate = ("one_card_split" if "one_card_split" in box[0]
                    else "whole")
            whole = box[0].get(gate)
            for data, model in meshes:
                mesh = make_debug_mesh(data, model, device=dev)
                runs, measures = [], {}
                with use_mesh(mesh):
                    sh = split_shardings(cfg, mesh)
                    for i in range(2):
                        p = tree_map(lambda t: t.to(dev),
                                     place(params0, sh["params"]))
                        opt = adamw_init(p)
                        held = _held_gib(torch, (p, opt))
                        flash = flash_ops.flash_attention
                        flash.launches = 0
                        r = _step(torch, step_fn, p, opt, batch)
                        r["flash_launches"] = flash.launches
                        r["held_gib"] = held
                        runs.append(r)
                        if i == 1 and whole is not None:   # after the timed
                            flat = flat_shardings(sh["params"])
                            trees = [tree_flatten(x)
                                     for x in (p, opt.mu, opt.nu)]

                            def get(j):        # every rank gathers
                                return tuple(gather_whole(t[j], flat[j])
                                             for t in trees)
                            for key in ("whole", f"blocks{data}",
                                        "one_card_split"):
                                if key not in box[0]:
                                    continue
                                if rank == 0:
                                    measures[key] = _compare(
                                        torch, get, refs[key][1], p0)
                                else:
                                    for j in range(len(flat)):
                                        get(j)
                            del trees
                        del p, opt
                        free()
                first = runs[0]
                ok = (all(math.isfinite(r[k]) for r in runs
                          for k in ("loss", "ce", "grad_norm"))
                      # the CPU takes the kernel's plain version
                      and all(r["flash_launches"] == (0 if cpu else
                                                      2 * cfg.n_layers)
                              for r in runs))
                line = {"rank": rank, "case": name, "mesh": [data, model],
                        "runs": runs, "init_s": init_s}
                if whole is not None:
                    errs = {k: abs(first[k] - whole[k]) / abs(whole[k])
                            for k in ("loss", "ce", "grad_norm")}
                    ok = (ok and errs["loss"] <= F32_TOL
                          and errs["ce"] <= F32_TOL
                          and errs["grad_norm"] <= BF16_TOL
                          and measures.get(gate, {}).get("ok", True))
                    line[f"relative_to_{gate}"] = errs
                if gate != "whole" and "whole" in box[0]:
                    line["relative_to_whole"] = {
                        k: abs(first[k] - box[0]["whole"][k])
                        / abs(box[0]["whole"][k])
                        for k in ("loss", "ce", "grad_norm")}
                blocked = box[0].get(f"blocks{data}")
                if blocked is not None:
                    line["relative_to_blocked"] = {
                        k: abs(first[k] - blocked[k]) / abs(blocked[k])
                        for k in ("loss", "ce", "grad_norm")}
                if measures:
                    line["state"] = measures
                line["ok"] = ok
                lines.append(line)
            del params0, refs
            free()
    finally:
        dist.destroy_process_group()
    with open(f"{out_path}.{rank}", "w") as f:
        json.dump(lines, f)


def main(argv=None) -> int:
    import torch
    import torch.multiprocessing as mp
    p = argparse.ArgumentParser()
    p.add_argument("--ranks", type=int, default=0,
                   help="ranks (default: every card)")
    p.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "mesh_probe.json"))
    p.add_argument("--cpu", action="store_true",
                   help="smoke configs at S 64 over gloo on the CPU (a "
                        "rehearsal of the script; no card)")
    p.add_argument("--cases", choices=("all", "dense", "moe"),
                   default="all", help="the dense cases, the MoE ones, or "
                                       "both (default)")
    args = p.parse_args(argv)
    n = args.ranks or (4 if args.cpu else torch.cuda.device_count())
    if n < 1 or (not args.cpu and torch.cuda.device_count() < n):
        print(f"mesh_probe: {n} ranks, {torch.cuda.device_count()} cards "
              f"visible", file=sys.stderr)
        return 1
    if not args.cpu:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        print(smi.stdout.strip()
              or f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {n} ranks",
          flush=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    if not args.cpu:
        from repro_torch.kernels import build
        build.build_all()
    mp.spawn(worker, args=(n, port, args.out, args.cpu, args.cases),
             nprocs=n, join=True)
    lines = []
    for r in range(n):
        with open(f"{args.out}.{r}") as f:
            lines += json.load(f)
    for line in lines:
        print(json.dumps(line))
    ok = all(line.get("ok", True) for line in lines)
    print(json.dumps({"ok": ok, "ranks": n,
                      "cases": [[c["name"], c["meshes"]]
                                for c in cases(n, args.cases)]}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
