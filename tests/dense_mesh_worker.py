"""One rank of a CPU mesh run of the port's dense split training step (not
a test file).  `tests/test_torch_dense_mesh.py` starts DATA x MODEL of
these, each with its rank, over gloo and a `FileStore` (no port is
opened):

    python tests/dense_mesh_worker.py STORE RANK DATA MODEL IN.npz OUT_DIR

IN.npz holds `cases` (JSON: each case's smoke arch, its config overrides,
the step's lr, warmup, total and step number, and whether to checkpoint
it) and, per case `c`, the whole params as `c__p<i>` in `tree_flatten`
order (bf16 leaves as their uint16 bits, `c__dtypes` naming each leaf's
dtype) and the global batch's `c__tokens`.  Under a (DATA, MODEL) debug
mesh the rank places the params into its blocks, runs one
`make_train_step` step on the global batch, and writes
OUT_DIR/r<RANK>.npz: per case the step's metrics, the bytes its param and
moment blocks hold beside `local_bytes` of their shardings, and (rank 0)
every param and moment gathered whole.  A case marked `ckpt` is also
saved under OUT_DIR/ckpt_<case> with its shardings (rank 0 writes it).
"""
import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist


def case_config(case):
    from repro_torch.configs import get_config
    cfg = get_config(case["arch"], smoke=True)
    return dataclasses.replace(cfg, **case.get("replace", {}))


def _leaf(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _held(tree) -> int:
    from repro_torch.tree import tree_flatten
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree))


def main(argv) -> None:
    import repro_torch.serving  # noqa: F401  (before launch.steps)
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.launch.dryrun import local_bytes
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import (make_train_step, opt_shardings,
                                          param_shardings)
    from repro_torch.nn.model import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import gather_whole, place, use_mesh
    from repro_torch.tree import tree_flatten, tree_unflatten

    store, rank, data, model, src, out_dir = argv
    rank, data, model = int(rank), int(data), int(model)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, data * model),
                            rank=rank, world_size=data * model)
    try:
        inp = np.load(src)
        out = {}
        mesh = make_debug_mesh(data, model, device="cpu")
        for case in json.loads(str(inp["cases"])):
            c = case["name"]
            cfg = case_config(case)
            dtypes = json.loads(str(inp[f"{c}__dtypes"]))
            like = init_params(cfg, device="meta")
            whole = tree_unflatten(like, [
                _leaf(inp[f"{c}__p{i}"], dt) for i, dt in enumerate(dtypes)])
            batch = {"tokens": torch.from_numpy(inp[f"{c}__tokens"])}
            step = make_train_step(cfg, peak_lr=case["lr"],
                                   warmup=case["warmup"], total=case["total"])
            with use_mesh(mesh):
                psh = param_shardings(cfg, mesh)
                osh = opt_shardings(psh, mesh)
                out[f"{c}__local_params"] = local_bytes(whole, psh)
                out[f"{c}__local_opt"] = local_bytes(adamw_init(whole), osh)
                params = place(whole, psh)
                del whole
                opt = adamw_init(params)
                out[f"{c}__held_params"] = _held(params)
                out[f"{c}__held_opt"] = _held(opt)
                params, opt, metrics = step(params, opt, batch,
                                            case["step"])
                for k, v in metrics.items():
                    out[f"{c}__m_{k}"] = float(v)
                wp = gather_whole(params, psh)
                wo = gather_whole(opt, osh)
                if case.get("ckpt"):
                    save_checkpoint(os.path.join(out_dir, f"ckpt_{c}"), 1,
                                    {"params": params, "opt": opt},
                                    shardings={"params": psh, "opt": osh})
            if rank == 0:
                for i, t in enumerate(tree_flatten(wp)):
                    out[f"{c}__p{i}"] = _np(t)
                for name in ("mu", "nu"):
                    for i, t in enumerate(tree_flatten(getattr(wo, name))):
                        out[f"{c}__{name}{i}"] = _np(t)
                out[f"{c}__opt_step"] = int(wo.step)
        np.savez(os.path.join(out_dir, f"r{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    main(sys.argv[1:])
