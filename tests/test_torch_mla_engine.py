"""The port's serving engine on the MoE families, and its launcher on
every new family, against the reference's on the CPU, with the
reference's `init_params(PRNGKey(0))` weights carried over:

  * deepseek-v2-lite smoke (MLA latent caches, a dense layer then MoE) and
    qwen3-moe smoke (GQA with qk_norm, every layer MoE), slot and paged
    layouts, monolithic and chunked prefill (chunks of 8 under an 8-token
    budget), on `tests/test_chunked_prefill.py::run_workload`'s schedule
    at seed 4, n 4 (`test_mla_moe_chunked_matches_monolithic`): the
    reference engine's tokens (`kernel_backend="xla"`) and per-step
    decode and chunk records, and the port's chunked tokens equal its
    monolithic ones;
  * the prefix cache on deepseek (paged, chunked, a shared prompt head):
    the reference's tokens, hit tokens and chunk counts;
  * `launch.serve --arch deepseek-v2-lite-16b --engine --smoke
    --virtual-clock` (slot and paged): its Chrome trace and metrics
    document equal the reference CLI's, but for the process-wide
    step-cache counters (`tests/test_torch_slot.py` makes the same
    exclusion);
  * the launcher's default mode (no mode flag) with `--arch` set to each
    new family: the reference CLI's printed token ids.

No token of these runs differs from the reference's, so no tie is pinned
(`tests/serving_pair.py::KNOWN_TIES` would hold one, with its logit gap).
"""
import json
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch import serve as ref_serve
from repro.nn.model import init_params as ref_init_params
from repro.serving import EngineModel as RefEngineModel
from repro.serving import SchedulerConfig as RefSchedulerConfig
from repro.serving import ServingEngine as RefServingEngine
from repro_torch.configs import get_config
from repro_torch.serving import EngineModel, SchedulerConfig, ServingEngine
from repro_torch.launch import serve
from repro_torch.tree import tree_map
from repro_torch.weights import params_from_reference

ARCHS = ("deepseek-v2-lite-16b", "qwen3-moe-235b-a22b")
_PARAMS = {}


def _params(arch):
    """(reference params for PRNGKey(0), port bf16 params through the
    bridge, port f32 params: the reference's values, for the weight
    store)."""
    if arch not in _PARAMS:
        ref = ref_init_params(jax.random.PRNGKey(0),
                              ref_config(arch, smoke=True))
        np_p = jax.tree.map(np.asarray, ref)
        _PARAMS[arch] = (ref, params_from_reference(
            np_p, get_config(arch, smoke=True), device="cpu"),
            tree_map(lambda a: torch.from_numpy(np.array(a)), np_p))
    return _PARAMS[arch]


def _engine(pkg, arch, *, layout="slot", chunk=0, budget=None,
            prefix_cache=False):
    """`tests/test_chunked_prefill.py::one_tenant_engine` of either
    package: one tenant "a", 3 rows, max_seq 48, page 4."""
    kw = dict(kv_slots=3, max_seq=48, kv_layout=layout, page_size=4,
              n_pages=0, prefix_cache=prefix_cache)
    if pkg == "ref":
        return RefServingEngine(
            [RefEngineModel("a", _params(arch)[0],
                            ref_config(arch, smoke=True),
                            kernel_backend="xla", **kw)],
            sched=RefSchedulerConfig(max_prefill_per_step=2,
                                     prefill_token_budget=budget),
            prefill_chunk=chunk, bucket_growth=2.0, staging_growth=2.0)
    return ServingEngine(
        [EngineModel("a", _params(arch)[1], get_config(arch, smoke=True),
                     **kw)],
        sched=SchedulerConfig(max_prefill_per_step=2,
                              prefill_token_budget=budget),
        prefill_chunk=chunk, bucket_growth=2.0, staging_growth=2.0,
        device="cpu")


def _workload(eng, n=4, seed=4, gen=5, lo=3, hi=20, head=()):
    """`run_workload`'s prompts (each after `head`, a shared prompt head)."""
    rng = np.random.default_rng(seed)
    vocab = next(iter(eng.models.values())).cfg.vocab
    reqs = [eng.submit("a", list(head) + rng.integers(
        1, vocab, int(rng.integers(lo, hi))).tolist(), max_new_tokens=gen)
        for _ in range(n)]
    s = eng.run()
    assert s["requests_finished"] == n
    return {"tokens": [list(r.generated) for r in reqs],
            "decode_batches": [st.n_decoded for st in eng.metrics.steps],
            "chunks": [st.n_prefill_chunks for st in eng.metrics.steps],
            **{k: s[k] for k in ("prefill_chunks", "prefill_tokens",
                                 "prefix_hit_tokens")}}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_engine_matches_reference_and_chunked_matches_monolithic(arch,
                                                                 layout):
    mono = _workload(_engine("port", arch, layout=layout))
    assert mono == _workload(_engine("ref", arch, layout=layout))
    chunked = _workload(_engine("port", arch, layout=layout, chunk=8,
                                budget=8))
    assert chunked == _workload(_engine("ref", arch, layout=layout, chunk=8,
                                        budget=8))
    assert chunked["tokens"] == mono["tokens"]
    assert chunked["prefill_chunks"] > 4


def test_prefix_cache_on_latent_pages_matches_reference():
    """Four prompts behind one 12-token head on the paged layout with the
    prefix cache: warm chunks are skipped from cached latent pages
    (`page_read`), with the reference's tokens, hit tokens and chunks."""
    arch = "deepseek-v2-lite-16b"
    head = list(range(3, 15))
    kw = dict(layout="paged", chunk=4, budget=8, prefix_cache=True)
    got = _workload(_engine("port", arch, **kw), head=head, lo=3, hi=9)
    assert got == _workload(_engine("ref", arch, **kw), head=head, lo=3,
                            hi=9)
    assert got["prefix_hit_tokens"] > 0


# ------------------------------------------------------------------ CLI
# the step caches' hit/miss/trace counters count every shape the process
# has run (process-wide in both packages), so they are not compared
TRACE_COUNTERS = "prefill_cache_"


def _ref_args(argv):
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_serve, "_run_engine",
                   lambda args: seen.setdefault("args", args))
        mp.setattr(sys, "argv", ["serve", *argv])
        ref_serve.main()
    return seen["args"]


def _cli_run(pkg, tmp_path, monkeypatch, extra):
    """One `--arch deepseek-v2-lite-16b --engine --smoke --virtual-clock`
    run of either CLI; the port runs on the reference's f32 weights (so
    its weight store quantizes the same values).  The once-only flush's
    atexit and SIGTERM hooks are not installed."""
    import atexit
    import signal
    monkeypatch.setattr(atexit, "register", lambda fn: None)
    monkeypatch.setattr(signal, "signal", lambda *a: None)
    out = tmp_path / pkg
    out.mkdir()
    argv = ["--arch", "deepseek-v2-lite-16b", "--engine", "--smoke",
            "--virtual-clock", "--requests", "4", "--prompt-len", "10",
            "--gen", "5", "--turn-steps", "2", "--trace-out",
            str(out / "trace.json"), "--metrics-json",
            str(out / "metrics.json"), *extra]
    if pkg == "ref":
        ref_serve._run_engine(_ref_args(argv))
    else:
        serve._run_engine(serve._parser().parse_args([*argv, "--device",
                                                      "cpu"]),
                          params=_params("deepseek-v2-lite-16b")[2])
    return (json.loads((out / "trace.json").read_text()),
            json.loads((out / "metrics.json").read_text()))


@pytest.mark.parametrize("extra", [[], ["--kv-layout", "paged"]],
                         ids=["slot", "paged"])
def test_engine_cli_on_deepseek_matches_the_reference(extra, tmp_path,
                                                      monkeypatch, capsys):
    """Two deepseek tenants (tenant-b the perturbed variant) through a
    weight arena of n_layers + 1 = 3 slots: the port's dense and MoE
    layers, of two sizes, install into one another's slots as the
    reference's do; trace and metrics equal the reference CLI's."""
    ref_trace, ref_doc = _cli_run("ref", tmp_path, monkeypatch, extra)
    trace, doc = _cli_run("port", tmp_path, monkeypatch, extra)
    out = capsys.readouterr().out
    assert "4 requests across 2 models" in out and "finished 4" in out
    assert trace == ref_trace
    assert {k: v for k, v in doc["summary"].items()
            if not k.startswith(TRACE_COUNTERS)} == \
        {k: v for k, v in ref_doc["summary"].items()
         if not k.startswith(TRACE_COUNTERS)}
    assert doc["metrics"] == ref_doc["metrics"]
    assert doc["summary"]["installs"] > 4           # the tenants switch


@pytest.mark.parametrize("arch", ["minicpm-2b", "yi-34b", "qwen3-32b",
                                  "deepseek-v2-lite-16b",
                                  "qwen3-moe-235b-a22b"])
def test_default_mode_on_the_new_families_matches_the_reference(
        arch, capsys, monkeypatch):
    """`--arch <family> --smoke`, no mode flag: `make_batch`'s 4 x 12
    prompt tokens, then 4 greedy steps at scalar positions.  The printed
    token ids equal the reference CLI's (both on PRNGKey(0)'s weights)."""
    argv = ["--arch", arch, "--smoke", "--prompt-len", "12", "--gen", "5"]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    ref_serve.main()
    want = capsys.readouterr().out.splitlines()[-1]
    serve.run_greedy(serve._parser().parse_args([*argv, "--device", "cpu"]),
                     params=_params(arch)[1])
    got = capsys.readouterr().out.splitlines()
    assert got[-1] == want and got[-1].startswith("sampled token ids:")
