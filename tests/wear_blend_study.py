"""Phase 9 of `chip_smoke.py` at smoke size, in both packages: two gemma-7b
tenants (smoke widths, 6 layers) behind an arena of n_layers + 2 weight
slots with instant installs, the paged layout at page 16 (4 rows a
tenant, 16 pages of headroom), 8 requests alternating between the
tenants and submitted up front, turns of 8 steps, on a VirtualClock.
Four arms: every knob off, the wear blend alone (`wear_aware=1.0`), the
faults alone (phase 9's rate, a seed whose plan retires one slot) and
both, which is phase 9's arm B.

It asks whether the weight Gini of cell flips (`wear_gini_weight`) and
the Gini of writes over the slots in service move with the blend, with
the faults or with both, and whether the port moves them as the
reference does.  `tests/test_torch_wear_blend.py` holds the port's arms
equal to the reference's.  Run:

    JAX_PLATFORMS=cpu PYTHONPATH=src:tests python tests/wear_blend_study.py
"""
import argparse
import dataclasses
import hashlib
import json

import jax
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.nn.model import init_params as ref_init_params
from repro.serving.variants import perturbed_variant as ref_variant
from repro_torch.configs import get_config
from repro_torch.serving import gini_coefficient
from repro_torch.tree import tree_map
from serving_pair import api

N_LAYERS = 6                   # at 2 the arena of n_layers + 2 holds both
PAGE = 16
TURN_STEPS = 8
FAULT_RATE = 0.004             # phase 9's rate
FAULT_SEED = 73826             # retires one of the 8 slots, two pages
ARMS = {"off": {},
        "wear": dict(wear_aware=1.0),
        "faults": dict(fault_rate=FAULT_RATE, fault_seed=FAULT_SEED),
        "both": dict(wear_aware=1.0, fault_rate=FAULT_RATE,
                     fault_seed=FAULT_SEED)}
_PARAMS = {}


def configs(n_layers):
    """(reference config, port config): gemma-7b smoke at `n_layers`."""
    return tuple(dataclasses.replace(get("gemma-7b", smoke=True),
                                     n_layers=n_layers)
                 for get in (ref_config, get_config))


def params(pkg, n_layers=N_LAYERS):
    """{"tenant-a", "tenant-b"} params of one package: the reference's
    `init_params(PRNGKey(0))` and its `perturbed_variant`, as f32 tensors
    for the port."""
    if n_layers not in _PARAMS:
        a = ref_init_params(jax.random.PRNGKey(0), configs(n_layers)[0])
        b = ref_variant(a)
        ref = {"tenant-a": a, "tenant-b": b}
        _PARAMS[n_layers] = {"ref": ref, "port": {
            n: tree_map(lambda x: torch.from_numpy(np.array(x)),
                        jax.tree.map(np.asarray, p))
            for n, p in ref.items()}}
    return _PARAMS[n_layers][pkg]


def requests(full=False):
    """Phase 9's requests cut to smoke size: 8, alternating tenants,
    prompts of 8-32 tokens, 6-12 new tokens each; `full`: phase 9's own
    lengths (prompts of 64-256 tokens, 24-32 new)."""
    rng = np.random.default_rng(1)
    (lo, hi), (glo, ghi) = ((64, 257), (24, 33)) if full else ((8, 33),
                                                               (6, 13))
    vocab = configs(1)[0].vocab
    return [(("tenant-a", "tenant-b")[i % 2],
             rng.integers(1, vocab, int(rng.integers(lo, hi))).tolist(),
             int(rng.integers(glo, ghi))) for i in range(8)]


def run(pkg, n_layers=N_LAYERS, full=False, **knobs):
    """One arm in one package; returns the engine after its last step."""
    SE, EM, SC, VC, _, _ = api(pkg)
    reqs = requests(full)
    max_seq = max(len(p) + n for _, p, n in reqs)
    cfg = configs(n_layers)[pkg == "port"]
    if pkg == "port":
        knobs["device"] = "cpu"
    eng = SE([EM(name, p, cfg, kv_slots=4, max_seq=max_seq,
                 kv_layout="paged", page_size=PAGE,
                 n_pages=4 * -(-max_seq // PAGE) + 16)
              for name, p in params(pkg, n_layers).items()],
             weight_arena_slots=n_layers + 2,
             sched=SC(max_prefill_per_step=4, model_turn_steps=TURN_STEPS),
             clock=VC(), **knobs)
    for model, prompt, n_new in reqs:
        eng.submit(model, prompt, max_new_tokens=n_new)
    for _ in range(2000):
        if not eng.has_work():
            return eng
        eng.step()
    raise AssertionError(f"{pkg} {knobs}: work left after 2000 steps")


def measure(eng):
    """The wear numbers phase 9 prints, of one finished engine."""
    s = eng.summary()
    writes = eng.wear.plane("weight").writes
    retired = eng.residency.retired
    return {"wear_gini_weight": float(s["wear_gini_weight"]),
            "writes_gini_in_service": float(gini_coefficient(
                [w for slot, w in enumerate(writes) if slot not in retired])),
            "install_cell_flips": int(s["install_cell_flips"]),
            "installs": int(s["installs"]),
            "slots_retired": sorted(int(u) for u in retired),
            "pages_retired": int(s["pages_retired"]),
            "steps": int(s["steps"])}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=N_LAYERS)
    ap.add_argument("--full-requests", action="store_true",
                    help="phase 9's prompt and generation lengths")
    ap.add_argument("--arms", nargs="+", default=list(ARMS),
                    choices=list(ARMS))
    ap.add_argument("--fault-seed", type=int, default=FAULT_SEED)
    args = ap.parse_args()
    for arm in args.arms:
        knobs = dict(ARMS[arm])
        if "fault_seed" in knobs:
            knobs["fault_seed"] = args.fault_seed
        for pkg in ("ref", "port"):
            eng = run(pkg, args.layers, args.full_requests, **knobs)
            tokens = {r.rid: list(r.generated) for r in eng.requests.values()}
            print(json.dumps({"arm": arm, "pkg": pkg, **measure(eng),
                              "tokens": hashlib.sha1(json.dumps(
                                  tokens).encode()).hexdigest()[:12]}))


if __name__ == "__main__":
    main()
