"""One rank of a CPU mesh run of the port's MoE layer (not a test file).
`tests/test_torch_moe_mesh.py` starts DATA x MODEL of these, each with its
rank, over gloo and a `FileStore` (no port is opened):

    python tests/mesh_worker.py STORE RANK DATA MODEL IN.npz OUT.npz

IN.npz holds the layer's config fields (`cfg`, JSON), its params (`p_*`,
the shared experts' MLP as `p_shared.<leaf>`) and the input `x`, all f32;
every rank loads the whole tensors, as the port's ranks hold them.  Under
a (DATA, MODEL) debug mesh the rank runs `moe` on `x` (the all-to-all
body) and on `x[:, :1]` with `decode=True` (the replicated body), then
each path's gradients of `sum((x + y) * x)` (a residual, as a block adds
it) in every param and in `x`, and writes its outputs and gradients
(`g_*` for the all-to-all path, `g1_*` for the replicated one) to
OUT.npz.
"""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.nn.config import ModelConfig  # noqa: E402
from repro_torch.nn.moe import moe  # noqa: E402
from repro_torch.parallel.sharding import use_mesh  # noqa: E402

def main(argv) -> None:
    store, rank, data, model, src, dst = argv
    rank, data, model = int(rank), int(data), int(model)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, data * model),
                            rank=rank, world_size=data * model)
    try:
        inp = np.load(src)
        cfg = ModelConfig(**json.loads(str(inp["cfg"])))
        leaves = {k[2:]: torch.from_numpy(inp[k]) for k in inp.files
                  if k.startswith("p_")}
        params = {k: v for k, v in leaves.items() if "." not in k}
        for k, v in leaves.items():
            if "." in k:
                outer, inner = k.split(".")
                params.setdefault(outer, {})[inner] = v
        x = torch.from_numpy(inp["x"])
        mesh = make_debug_mesh(data, model, device="cpu")
        out = {}
        with use_mesh(mesh):
            out["y"], out["aux"] = moe(params, x, cfg)
            out["y1"], out["aux1"] = moe(params, x[:, :1], cfg, decode=True)
            for t in leaves.values():
                t.requires_grad_(True)
            for tag, xs, decode in (("g", x, False),
                                    ("g1", x[:, :1], True)):
                xg = xs.clone().requires_grad_(True)
                yg, _ = moe(params, xg, cfg, decode=decode)
                grads = torch.autograd.grad(((xg + yg) * xg).sum(),
                                            list(leaves.values()) + [xg])
                for k, g in zip(list(leaves) + ["x"], grads):
                    out[f"{tag}_{k}"] = g
        np.savez(dst, **{k: v.detach().numpy() for k, v in out.items()})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
