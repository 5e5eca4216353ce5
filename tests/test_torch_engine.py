"""The port's serving engine against the reference engine on the schedule
of `tests/test_kernel_backend.py::_run_engine` (paged, prefix cache on,
COW > 0, preemption > 0, one temperature/top-k sampled request): the port
must give identical tokens and identical COW / preemption counts to the
reference with `kernel_backend="xla"`, fused and split, over bf16 and
int8 pools.  The sampled request draws from jax's threefry stream in both
packages, so its tokens are held to the reference's too."""
import dataclasses as dc

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.nn.model import init_params as ref_init_params
from repro.serving import EngineModel as RefEngineModel
from repro.serving import SchedulerConfig as RefSchedulerConfig
from repro.serving import ServingEngine as RefServingEngine
from repro_torch.configs import get_config
from repro_torch.serving import EngineModel, SchedulerConfig, ServingEngine
from repro_torch.serving.sampling import (request_key, sample_token,
                                          sample_tokens)
from repro_torch.weights import params_from_reference

RCFG = ref_config("gemma-7b", smoke=True)
CFG = get_config("gemma-7b", smoke=True)
REF_PARAMS = ref_init_params(jax.random.PRNGKey(0), RCFG)
PARAMS = params_from_reference(jax.tree.map(np.asarray, REF_PARAMS), CFG,
                               device="cpu")
PAGE = 4


def _schedule(eng, vocab, *, sampled):
    """`_run_engine`'s requests: r1 runs two steps, then an identical prompt
    arrives mid-decode (shares r1's live pages including the partial tail
    page, COWs it on its first decode write), plus enough load that the
    pool runs dry mid-decode."""
    rng = np.random.default_rng(5)
    shared = rng.integers(1, vocab, 10).tolist()
    reqs = [eng.submit("a", shared, max_new_tokens=8)]
    eng.step()
    eng.step()
    sampling = dict(temperature=0.9, top_k=7, seed=11) if sampled else {}
    reqs += [
        eng.submit("a", shared, max_new_tokens=8),
        eng.submit("a", rng.integers(1, vocab, 12).tolist(),
                   max_new_tokens=12),
        eng.submit("a", shared[:4], max_new_tokens=6, **sampling),
    ]
    eng.run()
    arena = eng.arenas["a"]
    stats = {"cow": arena.allocator.cow_copies,
             "preempt": sum(r.preemptions for r in reqs),
             "sync_max": max((rec.sample_syncs for rec in eng.metrics.steps
                              if rec.n_decoded), default=0)}
    return {r.rid: tuple(r.generated) for r in reqs}, stats


def _run_ref(kv):
    """The reference engine, `kernel_backend="xla"` (its fused and split
    arms agree token for token: tests/test_kernel_backend.py)."""
    cfg = dc.replace(RCFG, kv_cache_dtype=kv)
    eng = RefServingEngine(
        [RefEngineModel("a", REF_PARAMS, cfg, kv_slots=3, max_seq=24,
                        kv_layout="paged", page_size=PAGE, n_pages=10,
                        prefix_cache=True, kernel_backend="xla")],
        sched=RefSchedulerConfig(max_prefill_per_step=2))
    return _schedule(eng, cfg.vocab, sampled=True)


def _run_port(fuse, kv, sampled=True):
    cfg = dc.replace(CFG, kv_cache_dtype=kv)
    eng = ServingEngine(
        [EngineModel("a", PARAMS, cfg, kv_slots=3, max_seq=24,
                     kv_layout="paged", page_size=PAGE, n_pages=10,
                     prefix_cache=True)],
        sched=SchedulerConfig(max_prefill_per_step=2), fuse_sampling=fuse,
        device="cpu")
    return _schedule(eng, cfg.vocab, sampled=sampled)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_port_engine_tokens_match_reference(kv):
    want, want_stats = _run_ref(kv)
    assert want_stats["cow"] > 0 and want_stats["preempt"] > 0
    for fuse in (True, False):
        got, stats = _run_port(fuse, kv)
        assert got == want, fuse
        assert stats["cow"] == want_stats["cow"]
        assert stats["preempt"] == want_stats["preempt"]
        assert stats["sync_max"] == 1      # one host sync per decoded step


def test_sampled_schedule_is_deterministic():
    first = _run_port(True, "bf16", sampled=True)
    assert _run_port(True, "bf16", sampled=True) == first
    assert _run_port(False, "bf16", sampled=True) == first


def test_sample_tokens_matches_per_row_sampler():
    """`sample_tokens` is row-for-row identical to per-row `sample_token`
    across temperature / top-k / seed, with the padded vocab tail poisoned
    to +1e9 (it must be masked, not sampled)."""
    vocab, pad, B = CFG.vocab, 64, 6
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(
        rng.normal(size=(B, vocab + pad)).astype(np.float32))
    logits[:, vocab:] = 1e9
    for temp in (0.0, 0.7, 1.3):
        for tk in (0, 1, 5, vocab):
            for seed in (None, 7):
                keys = [request_key(seed, r) for r in range(B)]
                steps = [r * 3 for r in range(B)]
                want = [sample_token(logits[r], vocab, temperature=temp,
                                     top_k=tk, key=keys[r], step=steps[r])
                        for r in range(B)]
                got = sample_tokens(logits, vocab,
                                    temperatures=np.full(B, temp),
                                    top_ks=np.full(B, tk), keys=keys,
                                    steps=steps)
                assert got.dtype == torch.int32
                assert got.tolist() == want, (temp, tk, seed)
                assert all(t < vocab for t in want)
                if tk == 1:    # top-1 sampling is the greedy argmax
                    assert want == logits[:, :vocab].argmax(-1).tolist()


def test_engine_rejects_oversized_and_unknown_requests():
    eng = ServingEngine([EngineModel("a", PARAMS, CFG, kv_slots=2,
                                     max_seq=16, kv_layout="paged",
                                     page_size=PAGE)],
                        device="cpu")
    assert eng.submit("a", [1] * 30, max_new_tokens=4).status.value == \
        "rejected"
    with pytest.raises(KeyError):
        eng.submit("b", [1, 2])
    with pytest.raises(ValueError):
        eng.submit("a", [1, 2], max_new_tokens=0)
