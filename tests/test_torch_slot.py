"""The port's slot KV layout and the launcher's default mode against the
reference on the CPU at gemma-7b smoke (all equalities bit for bit):

  * `KVArena` bookkeeping, and its rows after `install`, equal the
    reference's for bf16 and int8 caches, unrolled and scanned segments;
  * `decode_step` without a page table (scalar and per-row positions, a
    stale row past the cache end, bf16 and int8, full attention, sliding
    windows below, at and above the cache length, logit softcap) gives the
    reference's logits and caches; full-attention layers attend through
    the `paged_attention` wrapper over the cache seen as pages, the others
    through the masked einsum;
  * `cached_stage_install` (ring, slice, int8 quantize) equals the
    reference's on the same staging;
  * the launcher: every engine flag's default, the no-flag greedy loop,
    the `--prefix-cache` refusal, and the `--engine --virtual-clock` run's
    Chrome trace and metrics document against the reference CLI's — and,
    with wear-aware placement, faults, telemetry and the flight recorder
    on, its wear map, events, Prometheus text, flight dumps and health
    line.

The slot engine's schedules are in `tests/test_torch_slot_engine.py`.
"""
import dataclasses as dc
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch import serve as ref_serve
from repro.launch.steps import cached_prefill_step as ref_prefill_step
from repro.launch.steps import cached_serve_step as ref_serve_step
from repro.launch.steps import cached_stage_install as ref_stage_install
from repro.nn.model import init_params as ref_init_params
from repro.serving import KVArena as RefKVArena
from repro_torch.configs import get_config
from repro_torch.serving import EngineModel, KVArena
from repro_torch.launch import serve
from repro_torch.launch.steps import cached_serve_step, cached_stage_install
from repro_torch.nn import attention as attn_mod
from repro_torch.tree import tree_map
from repro_torch.weights import params_from_reference

RCFG = ref_config("gemma-7b", smoke=True)
CFG = get_config("gemma-7b", smoke=True)
_PARAMS = {}


def _params(seed, rcfg=RCFG, cfg=CFG):
    """(reference params for PRNGKey(seed), port bf16 params through
    `params_from_reference`, port f32 params).  The f32 ones let the port's
    weight store quantize the reference's values, so installs match."""
    key = (seed, rcfg)
    if key not in _PARAMS:
        ref = ref_init_params(jax.random.PRNGKey(seed), rcfg)
        np_p = jax.tree.map(np.asarray, ref)
        _PARAMS[key] = (ref, params_from_reference(np_p, cfg, device="cpu"),
                        tree_map(lambda a: torch.from_numpy(np.array(a)),
                                 np_p))
    return _PARAMS[key]


def _np(x):
    """A leaf of either package as a numpy array (bf16 as f32)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
    return x


def _to_port(caches):
    """Reference caches -> port caches, leaf for leaf (bf16 stays bf16)."""
    def leaf(x):
        t = torch.from_numpy(np.array(_np(x)))
        return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t
    return [{"attn": {k: leaf(v) for k, v in seg["attn"].items()}}
            for seg in caches]


def _assert_caches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g["attn"]) == set(w["attn"])
        for name, leaf in w["attn"].items():
            assert g["attn"][name].shape == leaf.shape, name
            np.testing.assert_array_equal(_np(g["attn"][name]), _np(leaf),
                                          err_msg=name)


# ------------------------------------------------------------ KVArena
def _bookkeeping(arena_cls, **kw):
    a = arena_cls(CFG if arena_cls is KVArena else RCFG, n_slots=3,
                  max_seq=8, **kw)
    seen = [a.alloc(10), a.alloc(11), a.n_free, a.owner_of(0),
            a.active_slots()]
    seen += [a.evict(0), a.evict(0), a.n_free, a.owner_of(0),
             a.alloc(12), a.alloc(13), a.alloc(14), a.active_slots(),
             a.evictions]
    a.advance(1, 7)
    a.advance(1, 9)
    tok, pos = a.decode_inputs()
    return seen + [_np(tok).tolist(), _np(pos).tolist()]


def test_kv_arena_bookkeeping_matches_reference():
    """`tests/test_serving.py::test_kv_arena_slot_bookkeeping`'s operations
    (FIFO free list, stale-slot eviction) on both arenas."""
    got = _bookkeeping(KVArena, device="cpu")
    assert got == _bookkeeping(RefKVArena)
    assert got[:3] == [0, 1, 1] and got[9:12] == [2, 0, None]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("variant", [{}, {"n_layers": 4}],
                         ids=["single", "scanned"])
def test_kv_arena_install_rows_match_reference(kv, variant):
    """The reference's batch-1 prefill caches installed into slots 2, 0
    and 2 again (over its stale row) of both arenas: every row of the
    port's equals the reference's."""
    rc = dc.replace(RCFG, kv_cache_dtype=kv, **variant)
    c = dc.replace(CFG, kv_cache_dtype=kv, **variant)
    ref_p = _params(0, dc.replace(RCFG, **variant),
                    dc.replace(CFG, **variant))[0]
    ref = RefKVArena(rc, n_slots=3, max_seq=16)
    port = KVArena(c, n_slots=3, max_seq=16, device="cpu")
    rng = np.random.default_rng(2)
    for slot, n in ((2, 9), (0, 5), (2, 7)):
        prompt = rng.integers(1, c.vocab, n)
        _, rone = ref_prefill_step(rc, 16)(
            ref_p, {"tokens": jnp.asarray(prompt, jnp.int32)[None]})
        port.install(slot, _to_port(rone), 3, n)
        ref.install(slot, rone, 3, n)
    _assert_caches_equal(port.caches, ref.caches)
    assert port.pos.tolist() == ref.pos.tolist()


# ------------------------------------------------------- decode_step
DECODE_VARIANTS = {
    "full": {}, "window-4": {"sliding_window": 4},
    "window-16": {"sliding_window": 16}, "window-24": {"sliding_window": 24},
    "softcap": {"logit_softcap": 30.0}}
L, S, B = 16, 6, 3
BF16_TOL = 2e-2     # the reference's bf16 tolerance, tests/test_kernels.py:94


def _check_einsum_step(got, want, caches, rcaches, before, slots):
    """The einsum route's step against the reference's from the same
    caches `before`: each row's write lands at `slots[b]` and nowhere else
    (bit for bit outside it, in both packages); layer 0's write, which no
    attention precedes, equals the reference's bit for bit; later layers'
    writes and the logits sit within the bf16 tolerance (int8 codes within
    one), with the same greedy pick."""
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_TOL,
                               atol=BF16_TOL)
    assert (_np(got).argmax(-1) == _np(want).argmax(-1)).all()
    rows = np.arange(B)
    for li, (g, w, b) in enumerate(zip(caches, rcaches, before)):
        for name, leaf in w["attn"].items():
            gn, wn, bn = (_np(g["attn"][name]), _np(leaf),
                          _np(b["attn"][name]))
            keep = np.ones(bn.shape[:2], bool)
            keep[rows, slots] = False
            np.testing.assert_array_equal(gn[keep], bn[keep], err_msg=name)
            np.testing.assert_array_equal(wn[keep], bn[keep], err_msg=name)
            if li == 0:
                np.testing.assert_array_equal(gn, wn, err_msg=name)
            elif name in ("k", "v") and gn.dtype == np.int8:
                assert np.abs(gn.astype(int) - wn).max() <= 1, name
            else:
                np.testing.assert_allclose(gn, wn, rtol=BF16_TOL,
                                           atol=BF16_TOL, err_msg=name)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("variant", list(DECODE_VARIANTS))
def test_decode_step_without_table_matches_reference(kv, variant,
                                                     monkeypatch):
    """From one batch prefill of cache length 16: three steps at scalar
    positions 6, 7, 8, and three at per-row positions [6, 3, 15] + step (the
    last row past the cache end: its write clamps to the last slot); the
    windows below (a ring of 4 that wraps), at and above the cache length.

    Each step starts both packages from the reference's caches.  Full
    attention goes through the paged wrapper over the cache seen as pages
    (its plain version on the CPU), and its logits and caches equal the
    reference's bit for bit.  Window and softcap layers run the masked
    einsum, whose f32 products and softmax are torch's, not XLA's: about
    one bf16 output in 2e4 rounds one ulp apart (as the chunk attention's
    does, `tests/test_torch_chunked_prefill.py`), and an int8 tenant can
    turn that into a code.  They are held as `_check_einsum_step` says."""
    rc = dc.replace(RCFG, kv_cache_dtype=kv, **DECODE_VARIANTS[variant])
    c = dc.replace(CFG, kv_cache_dtype=kv, **DECODE_VARIANTS[variant])
    ref_p, port_p, _ = _params(0)
    calls = []
    plain = attn_mod.paged_attention
    monkeypatch.setattr(attn_mod, "paged_attention",
                        lambda *a: calls.append(a[1].shape) or plain(*a))
    full = variant == "full"
    window = c.sliding_window
    tokens = np.random.default_rng(3).integers(1, c.vocab, (B, S))
    for per_row in (False, True):
        _, rcaches = ref_prefill_step(rc, L)(
            ref_p, {"tokens": jnp.asarray(tokens, jnp.int32)})
        tok = np.array([5, 9, 11], np.int32)
        for step in range(3):
            pos = (np.array([S, 3, L - 1], np.int32) + step if per_row
                   else np.int32(S + step))
            before = _to_port(rcaches)
            caches = _to_port(rcaches)
            want, rcaches = ref_serve_step(rc)(
                ref_p, jnp.asarray(tok), rcaches, jnp.asarray(pos))
            got, caches = cached_serve_step(c)(
                port_p, torch.from_numpy(tok), caches,
                torch.from_numpy(np.asarray(pos)))
            if full:
                np.testing.assert_array_equal(_np(got), _np(want))
                _assert_caches_equal(caches, rcaches)
            else:
                pos_b = np.broadcast_to(pos, (B,))
                slots = (pos_b % window if 0 < window <= L
                         else np.minimum(pos_b, L - 1))
                _check_einsum_step(got, want, caches, rcaches, before, slots)
            tok = np.array(jnp.argmax(want[:, :c.vocab], -1), np.int32)
    assert len(calls) == (2 * 3 * c.n_layers if full else 0)
    if full:   # each row's 16 positions seen as one page of 16 tokens
        assert calls[0] == (B, 16, c.n_kv_heads, c.head_dim)


def test_page_view_sizes():
    assert [attn_mod._page_view(n) for n in (16, 552, 544, 24, 9, 6)] == \
        [16, 8, 16, 8, 1, 2]


# ------------------------------------------------ cached_stage_install
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("variant", [
    {}, {"n_layers": 4}, {"sliding_window": 6},
    {"sliding_window": 6, "n_layers": 4}, {"sliding_window": 24}],
    ids=["single", "scanned", "window-6", "window-6-scanned", "window-24"])
@pytest.mark.parametrize("true_len", [4, 13])
def test_stage_install_matches_reference(kv, variant, true_len):
    """The same random staging (32 positions) through both packages'
    staging -> slot-row install at an arena length of 24: windowed layers
    ringed (a prompt shorter and longer than the window), the rest sliced,
    int8 quantized."""
    rc = dc.replace(RCFG, kv_cache_dtype=kv, **variant)
    c = dc.replace(CFG, kv_cache_dtype=kv, **variant)
    from repro.nn.model import init_cache as ref_init_cache
    rng = np.random.default_rng(true_len)
    staging = jax.tree.map(
        lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype),
        ref_init_cache(rc, 1, 32, staging=True))
    want = ref_stage_install(rc, 32, 24)(staging, jnp.int32(true_len))
    got = cached_stage_install(c, 32, 24)(_to_port(staging), true_len)
    _assert_caches_equal(got, want)


# ------------------------------------------------------------ CLI
NEW_FLAGS = ("kv_layout", "queue_policy", "no_fuse_sampling", "trace_out",
             "metrics_json", "virtual_clock")


def _ref_args(argv):
    """The reference parser's namespace for an `--engine` argv, parsed by
    its `main` with `_run_engine` intercepted."""
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_serve, "_run_engine",
                   lambda args: seen.setdefault("args", args))
        mp.setattr(sys, "argv", ["serve", *argv])
        ref_serve.main()
    return seen["args"]


def test_engine_cli_new_flag_defaults_match_the_reference():
    """The port's parser has every flag of the reference's but
    `--kernel-backend` (the port launches its CUDA kernels on a CUDA
    tensor, so there is no backend to pick), with the reference's
    defaults, plus `--device`."""
    want = vars(_ref_args(["--engine"]))
    got = vars(serve._parser().parse_args(["--engine"]))
    assert set(got) - {"device"} == set(want) - {"kernel_backend"}
    for flag in set(got) - {"device"}:
        assert got[flag] == want[flag], flag
    assert set(NEW_FLAGS) < set(got)
    assert got["kv_layout"] == "slot"


def test_prefix_cache_needs_paged_as_in_the_reference():
    argv = ["--engine", "--smoke", "--prefix-cache"]
    with pytest.raises(SystemExit) as want:
        ref_serve._run_engine(_ref_args(argv))
    with pytest.raises(SystemExit) as got:
        serve._run_engine(serve._parser().parse_args([*argv, "--device",
                                                      "cpu"]))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="prefix_cache"):
        EngineModel("a", None, CFG, prefix_cache=True)
    with pytest.raises(ValueError, match="kv_layout"):
        EngineModel("a", None, CFG, kv_layout="rows")


def test_default_mode_greedy_loop_matches_the_reference(capsys,
                                                        monkeypatch):
    """No mode flag: `make_batch`'s 4 x 32 prompt tokens, then 15 greedy
    steps at scalar positions.  Its printed token ids equal the reference
    CLI's, and its whole token array the reference's loop."""
    argv = ["--smoke", "--prompt-len", "12", "--gen", "5"]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    ref_serve.main()
    want_out = capsys.readouterr().out.splitlines()[-1]
    args = serve._parser().parse_args([*argv, "--device", "cpu"])
    toks, _, _ = serve.run_greedy(args, params=_params(0)[1])
    got_out = capsys.readouterr().out.splitlines()
    assert got_out[-1] == want_out
    assert got_out[0].startswith("prefill 4×12: ")
    from repro.data.pipeline import DataConfig, make_batch
    batch = make_batch(RCFG, DataConfig(seq_len=12, global_batch=4), 0)
    logits, caches = ref_prefill_step(RCFG, 17)(
        _params(0)[0], {"tokens": jnp.asarray(batch["tokens"])})
    want = [jnp.argmax(logits, -1).astype(jnp.int32)]
    for i in range(4):
        logits, caches = ref_serve_step(RCFG)(_params(0)[0], want[-1],
                                              caches, jnp.int32(12 + i))
        want.append(jnp.argmax(logits, -1).astype(jnp.int32))
    np.testing.assert_array_equal(toks, np.stack(want, 1))


# the step caches' hit/miss/trace counters count every shape the process
# has run (`launch.steps.prefill_cache_info`, process-wide in both
# packages), so they depend on the tests that ran before, not on this run
TRACE_COUNTERS = "prefill_cache_"
# the wear map, events, Prometheus text and flight dumps a CLI run writes
# with the planes on (`--flight-dir` is the package's own directory)
ARTIFACTS = {"--wear-json": "wear.json", "--events-out": "events.jsonl",
             "--prom-out": "prom.txt"}


def _cli_run(pkg, tmp_path, monkeypatch, extra, planes=()):
    """One `--engine --smoke --virtual-clock --trace-out --metrics-json`
    run of either CLI, its files written into `tmp_path / pkg`; `planes`
    are further flags whose artifacts (`ARTIFACTS`, flight dumps) land
    there too.  The once-only flush's atexit and SIGTERM hooks, and the
    flight recorder's SIGUSR1 handler, are recorded, not installed; its
    excepthook is undone.  Returns (trace, metrics document, {artifact
    name: bytes})."""
    import atexit
    import signal
    hooks = []
    monkeypatch.setattr(atexit, "register", lambda fn: hooks.append(fn))
    monkeypatch.setattr(signal, "signal", lambda *a: hooks.append(a[0]))
    monkeypatch.setattr(sys, "excepthook", sys.excepthook)
    out = tmp_path / pkg
    out.mkdir()
    argv = ["--engine", "--smoke", "--virtual-clock", "--requests", "6",
            "--prompt-len", "10", "--gen", "5", "--turn-steps", "2",
            "--trace-out", str(out / "trace.json"), "--metrics-json",
            str(out / "metrics.json"), *extra]
    if planes:
        argv += [*planes, "--flight-dir", str(out)]
        argv += [a for flag, name in ARTIFACTS.items()
                 for a in (flag, str(out / name))]
    if pkg == "ref":
        ref_serve._run_engine(_ref_args(argv))
    else:
        serve._run_engine(serve._parser().parse_args([*argv, "--device",
                                                      "cpu"]),
                          params=_params(0)[2])
    want_hooks = [signal.SIGUSR1] if planes else []
    assert [h for h in hooks if not callable(h)] == \
        [*want_hooks, signal.SIGTERM]
    files = {f.name: f.read_bytes() for f in sorted(out.iterdir())}
    return (json.loads(files.pop("trace.json")),
            json.loads(files.pop("metrics.json")), files)


@pytest.mark.parametrize("extra", [
    [], ["--kv-layout", "paged", "--no-fuse-sampling", "--queue-policy",
         "sjf"],
    ["--prefill-chunk", "4", "--prefill-token-budget", "8"]],
    ids=["slot", "paged-split-sjf", "slot-chunked"])
def test_engine_cli_trace_and_metrics_match_the_reference(
        extra, tmp_path, monkeypatch, capsys):
    """The CLI's engine set-up on the reference's weights (tenant-a
    PRNGKey(0), tenant-b its perturbed variant), on a VirtualClock with a
    Tracer: the Chrome trace's events (the wear plane's counter tracks
    included) and the metrics document (its wear, energy and fault keys
    and the install-flip histogram included) equal the reference CLI's,
    but for the process-wide step-cache counters (`TRACE_COUNTERS`)."""
    ref_trace, ref_doc, _ = _cli_run("ref", tmp_path, monkeypatch, extra)
    trace, doc, _ = _cli_run("port", tmp_path, monkeypatch, extra)
    out = capsys.readouterr().out
    assert "6 requests across 2 models" in out and "finished 6" in out
    _assert_same_trace_and_metrics(trace, doc, ref_trace, ref_doc)
    assert any(k.startswith(TRACE_COUNTERS) for k in doc["summary"]) == \
        ("--prefill-chunk" in extra)


def _assert_same_trace_and_metrics(trace, doc, ref_trace, ref_doc):
    assert {e["name"] for e in trace["traceEvents"] if e["ph"] == "C"} >= \
        {"install_flips", "wear_gini_weight"}
    assert trace == ref_trace
    assert {k: v for k, v in doc["summary"].items()
            if not k.startswith(TRACE_COUNTERS)} == \
        {k: v for k, v in ref_doc["summary"].items()
         if not k.startswith(TRACE_COUNTERS)}
    assert {"install_energy_j", "wear_gini_weight", "faults_survived"} <= \
        set(doc["summary"])
    assert any(k.startswith("install_cell_flips") for k in doc["metrics"])
    assert doc["metrics"] == ref_doc["metrics"]


# seed 9 at rate 0.05 retires one of the three weight slots (the arena
# survives one retirement: a tenant needs two) and two KV pages
PLANES = ["--kv-layout", "paged", "--page-size", "4", "--wear-aware",
          "--fault-rate", "0.05", "--fault-seed", "9",
          "--flight-recorder-steps", "16", "--slo-itl-p95", "0.001"]


def test_engine_cli_wear_faults_and_telemetry_match_the_reference(
        tmp_path, monkeypatch, capsys):
    """`--wear-aware --fault-rate --fault-seed --wear-json --events-out
    --prom-out --flight-recorder-steps --slo-itl-p95` on the paged layout
    under `--virtual-clock`: the trace, the metrics document and every
    artifact (wear map, events, Prometheus text, each flight dump) equal
    the reference CLI's byte for byte, and so do the summary's wear and
    fault lines and the printed health snapshot."""
    ref_trace, ref_doc, ref_files = _cli_run("ref", tmp_path, monkeypatch,
                                             [], PLANES)
    ref_out = capsys.readouterr().out
    trace, doc, files = _cli_run("port", tmp_path, monkeypatch, [], PLANES)
    out = capsys.readouterr().out
    _assert_same_trace_and_metrics(trace, doc, ref_trace, ref_doc)
    assert doc["summary"]["slots_retired"] == 1.0
    assert doc["summary"]["pages_retired"] == 2.0
    dumps = [n for n in files if n.startswith("flight-")]
    assert "flight-000-unit_retired.json" in dumps
    assert any(n.endswith("slo_breach.json") for n in dumps)
    assert set(files) == set(ARTIFACTS.values()) | set(dumps)
    assert files == ref_files
    from repro_torch.serving import (validate_events_jsonl,
                                     validate_prometheus_text)
    assert validate_events_jsonl(files["events.jsonl"].decode()) == []
    assert validate_prometheus_text(files["prom.txt"].decode()) == []

    def lines(text, *heads):
        return [ln for ln in text.splitlines() if ln.startswith(heads)]
    heads = ("wear:", "faults:", "health:", "tenant ")
    assert len(lines(out, *heads)) == 5
    assert lines(out, *heads) == lines(ref_out, *heads)
