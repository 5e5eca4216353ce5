"""`chip_smoke.py` phase 14's "loss falls" check at minicpm-2b's full
widths, in both packages, on the CPU: d_model 2304, 36 heads of 64,
d_ff 5,760, with the depth and the vocab cut (defaults: 4 layers, a
stacked segment with remat, and a vocab of 8,192) and a small batch.
From the reference trainer's params (`init_params(PRNGKey(0))`, every
float leaf of two or more dims in bf16), `make_train_step(peak_lr=lr,
warmup=1)` takes STEPS updates on one repeated `make_batch` batch in
each package, at each lr given.

It asks whether a loss that rises at the CLI's lr of 3e-4 with no warmup
rises in the reference too, which would make it Adam's first updates
(every weight moved by about the lr) and not a fault of the port that
grows with width.  It prints each package's losses by step and lr.  Run:

    JAX_PLATFORMS=cpu PYTHONPATH=src:tests python tests/train_lr_study.py
"""
import argparse
import dataclasses
import gc
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.data.pipeline import DataConfig
from repro.data.pipeline import make_batch as ref_make_batch
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.nn.model import init_params as ref_init_params
from repro.optim.adamw import adamw_init as ref_adamw_init
import repro_torch.serving  # noqa: F401  (before launch.steps)
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import adamw_init

from train_pair import to_torch

STEPS = 3


def reference(rcfg, batch, lr):
    params = ref_init_params(jax.random.PRNGKey(0), rcfg)
    params = jax.tree.map(
        lambda a: a.astype(jnp.bfloat16)
        if jnp.issubdtype(a.dtype, jnp.floating) and a.ndim >= 2 else a,
        params)
    host = jax.tree.map(np.asarray, params)
    step_fn = jax.jit(ref_make_train_step(rcfg, peak_lr=lr, warmup=1))
    opt, losses = ref_adamw_init(params), []
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for step in range(1, STEPS + 1):
        params, opt, m = step_fn(params, opt, jb, jnp.int32(step))
        losses.append(float(m["loss"]))
    return host, losses


def port(cfg, host, batch, lr):
    params = to_torch(host)
    step_fn = make_train_step(cfg, peak_lr=lr, warmup=1)
    opt, losses = adamw_init(params), []
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for step in range(1, STEPS + 1):
        params, opt, m = step_fn(params, opt, tb, step)
        losses.append(float(m["loss"]))
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, nargs="+", default=[3e-4, 1e-5])
    args = ap.parse_args()
    cut = dict(n_layers=args.layers, vocab=args.vocab)
    rcfg = dataclasses.replace(ref_config("minicpm-2b"), **cut)
    cfg = dataclasses.replace(get_config("minicpm-2b"), **cut)
    batch = ref_make_batch(rcfg, DataConfig(seq_len=args.seq,
                                            global_batch=args.batch), 0)
    for lr in args.lr:
        host, ref_losses = reference(rcfg, batch, lr)
        gc.collect()
        port_losses = port(cfg, host, batch, lr)
        del host
        gc.collect()
        print(json.dumps({"arch": "minicpm-2b", **cut, "batch": args.batch,
                          "seq": args.seq, "lr": lr, "warmup": 1,
                          "reference": ref_losses, "port": port_losses}),
              flush=True)


if __name__ == "__main__":
    main()
