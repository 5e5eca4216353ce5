"""Training launcher of the port, as `repro.launch.train`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --smoke --device cpu --steps 50 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --steps 3 --batch 4 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch deepseek-v2-lite-16b --smoke --mesh debug --steps 2

Deterministic step-indexed data (resume = set step), periodic async
checkpoints with atomic rename in the reference's format (the port
resumes the reference trainer's checkpoints, and the reference the
port's), an emergency checkpoint on a watchdog timeout, and straggler
statistics.  The step is `launch.steps.make_train_step`: autograd through
`lm_loss` with every block rematerialized, the flash kernel's
forward and the reference's flash backward on causal attention layers,
then AdamW in place.  Runs on the card unless `--device cpu`.  The step
runs under `--mesh`'s mesh (`parallel.sharding.use_mesh`): `none`, or
`debug`, a 1 x 1 (data, model) mesh on one rank (a one-rank NCCL group
on the card, gloo with `--device cpu`); `pod` and `multipod` need 256
and 512 ranks and raise on fewer.  Under a mesh the dense GQA and the
MoE families train on the split path (`launch.steps.split_shardings`;
the MoE layers route each rank's tokens through the reference's
expert-parallel all-to-all body, capacity dispatch and drops included):
after `init_params` the params and moments are placed into this rank's
blocks, a restore places its leaves the same way, and a checkpoint
gathers them whole (rank 0 writes).
"""
from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint, wait_for_saves)
from repro_torch.configs import ARCHS, get_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.device import resolve_device
from repro_torch.ft import StepTimer, Watchdog
# serving before launch.steps: the steps module imports serving.sampling,
# whose package imports the engine, which imports the steps
import repro_torch.serving  # noqa: F401
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.launch.steps import make_train_step, split_shardings
from repro_torch.nn.model import init_params
from repro_torch.optim.adamw import adamw_init
from repro_torch.parallel.sharding import current_mesh, place, use_mesh
from repro_torch.tree import tree_map


def cast_for_training(params):
    """The reference trainer's param dtypes: every float leaf of two or
    more dims in bf16 (the router, A_log, MLA's w_uk / w_uv and stacked
    norm scales too), every other float leaf in f32."""
    def cast(t):
        if not t.is_floating_point():
            return t
        return t.to(torch.bfloat16 if t.dim() >= 2 else torch.float32)
    return tree_map(cast, params)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ARCHS, default="minicpm-2b")
    p.add_argument("--smoke", action="store_true",
                   help="reduced config (CPU-sized)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--mesh", choices=("none", "debug", "pod", "multipod"),
                   default="none")
    p.add_argument("--watchdog-s", type=float, default=600.0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain kernel versions)")
    return p


def _mesh(kind: str, dev):
    if kind == "debug":
        return make_debug_mesh(1, 1, device=dev)
    if kind in ("pod", "multipod"):
        return make_production_mesh(multi_pod=kind == "multipod", device=dev)
    return None


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    started = not dist.is_initialized()
    try:
        with use_mesh(_mesh(args.mesh, dev)):
            _train(args, dev)
    finally:
        # a process group the mesh started ends with the run
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, dev) -> None:
    cfg = get_config(args.arch, smoke=args.smoke)
    data = DataConfig(seq_len=args.seq, global_batch=args.batch)

    params = cast_for_training(init_params(cfg, seed=0, device=dev))
    ctx = current_mesh()
    shardings = split_shardings(cfg, ctx.mesh) if ctx is not None else None
    if shardings is not None:
        params = place(params, shardings["params"])
    opt_state = adamw_init(params)
    start = 0
    if args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            state = restore_checkpoint(args.ckpt_dir, last,
                                       {"params": params, "opt": opt_state},
                                       shardings)
            params, opt_state = state["params"], state["opt"]
            start = last
            print(f"resumed from step {last}")

    step_fn = make_train_step(cfg, peak_lr=args.lr)
    timer = StepTimer()

    def emergency(step: int) -> None:
        if args.ckpt_dir:
            print(f"WATCHDOG: step {step} hung; emergency checkpoint")
            save_checkpoint(args.ckpt_dir, step,
                            {"params": params, "opt": opt_state},
                            shardings=shardings)

    wd = Watchdog(args.watchdog_s, on_timeout=emergency)

    for step in range(start, args.steps):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in
                 make_batch(cfg, data, step).items()}
        timer.start()
        with wd.armed(step):
            params, opt_state, metrics = step_fn(params, opt_state, batch,
                                                 step)
            metrics = {k: float(v) for k, v in metrics.items()}
        dt = timer.stop()
        rep = timer.report(step)
        flag = " STRAGGLER" if rep.flagged else ""
        print(f"step {step:5d} loss={metrics['loss']:.4f} "
              f"ce={metrics['ce']:.4f} gnorm={metrics['grad_norm']:.3f} "
              f"lr={metrics['lr']:.2e} {dt*1e3:8.1f} ms{flag}",
              flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step + 1,
                            {"params": params, "opt": opt_state},
                            block=False, shardings=shardings)
    if args.ckpt_dir:
        wait_for_saves()
        save_checkpoint(args.ckpt_dir, args.steps,
                        {"params": params, "opt": opt_state},
                        shardings=shardings)
    print("done")


if __name__ == "__main__":
    main()
