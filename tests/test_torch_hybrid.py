"""hymba (SWA and global attention beside Mamba) and xLSTM (mLSTM + sLSTM)
on the port's model and slot engine, against the reference on the CPU at
smoke size:

  * prefill, forward and three slot-decode steps (per-row positions):
    logits bit-equal but for a rare ulp (within 2e-2, at most 1% of them
    off), caches within 3e-4 (f32 states) or as the logits (bf16 K/V and
    conv windows);
  * `chunk_prefill` chunk by chunk into a staging cache (a padded tail of
    5 valid tokens of 8): the reference's logits and staging, the last
    chunk's logits the port's monolithic prefill's greedy pick;
  * the slot arena's install writes every leaf of a recurrent cache, and
    the staging install rings only attention entries (the two repairs);
  * the engine: `tests/test_chunked_prefill.py`'s hymba schedule
    (monolithic, chunks of 8, chunks of 16 under a budget of 8) gives the
    reference engine's tokens; an xLSTM schedule gives the reference's
    sequential greedy loop's (the reference's slot engine cannot serve
    xLSTM: its sLSTM cache shares one zero buffer among c, n and h, and
    the donated slot write refuses it); an mLSTM tenant refuses chunked
    prefill and the paged arena refuses both families, with the
    reference's messages;
  * the launcher's default mode on both, and hymba's `--engine` run (trace
    and metrics), against the reference CLI's.
"""
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
from repro.nn.model import chunk_prefill as ref_chunk_prefill
from repro.nn.model import decode_step as ref_decode_step
from repro.nn.model import forward as ref_forward
from repro.nn.model import init_cache as ref_init_cache
from repro.nn.model import init_params as ref_init_params
from repro.nn.model import prefill as ref_prefill
from repro.serving import EngineModel as RefEngineModel
from repro.serving import PagedKVArena as RefPagedKVArena
from repro.serving import SchedulerConfig as RefSchedulerConfig
from repro.serving import ServingEngine as RefServingEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.launch.steps import cached_stage_install
from repro_torch.nn.model import (chunk_prefill, decode_step, forward,
                                  init_cache, prefill)
from repro_torch.serving import (EngineModel, KVArena, PagedKVArena,
                                 SchedulerConfig, ServingEngine)
from repro_torch.tree import tree_map
from repro_torch.weights import params_from_reference

ARCHS = ("hymba-1.5b", "xlstm-350m")
BF16_TOL = 2e-2
STATE_TOL = 3e-4
MAX_ULP_SHARE = 0.01
MAX_SEQ = 40
_PARAMS = {}


def _params(arch):
    """(reference cfg, port cfg, reference params for PRNGKey(0), port
    params through the bridge, port params as the reference's f32
    values)."""
    if arch not in _PARAMS:
        rcfg, cfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
        ref = ref_init_params(jax.random.PRNGKey(0), rcfg)
        np_p = jax.tree.map(np.asarray, ref)
        _PARAMS[arch] = (rcfg, cfg, ref,
                         params_from_reference(np_p, cfg, device="cpu"),
                         tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  np_p))
    return _PARAMS[arch]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_bf16(want, got):
    """Within BF16_TOL and bit-equal but for at most MAX_ULP_SHARE of the
    elements (an f32 ulp of XLA's and torch's transcendentals or sums
    flipping a bf16 rounding; a missed rounding point moves many more)."""
    a, b = _np(got), _np(want)
    np.testing.assert_allclose(a, b, atol=BF16_TOL, rtol=0)
    assert (a != b).mean() <= MAX_ULP_SHARE, (a != b).mean()


def _by_key(tree, path=()):
    """{path: leaf} with dict paths by key (jax sorts keys, the port keeps
    insertion order)."""
    if isinstance(tree, dict):
        return {p: l for k in tree for p, l in _by_key(tree[k],
                                                      path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: l for i, t in enumerate(tree)
                for p, l in _by_key(t, path + (i,)).items()}
    return {path: tree}


def _assert_caches(want, got):
    want, got = _by_key(want), _by_key(got)
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert tuple(got[path].shape) == tuple(leaf.shape), path
        if np.dtype(leaf.dtype) == np.float32:
            np.testing.assert_allclose(_np(got[path]), _np(leaf),
                                       atol=STATE_TOL, rtol=0,
                                       err_msg=str(path))
        else:
            _assert_bf16(leaf, got[path])


def _tokens(cfg, *shape, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab,
                                                shape).astype(np.int32)


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_forward_and_slot_decode_match_reference(arch):
    rcfg, cfg, rp, pp, _ = _params(arch)
    toks = _tokens(cfg, 2, 21)
    want, rc = jax.jit(lambda p, t: ref_prefill(
        p, {"tokens": t}, rcfg, MAX_SEQ))(rp, jnp.asarray(toks))
    got, pc = prefill(pp, {"tokens": torch.from_numpy(toks).long()}, cfg,
                      MAX_SEQ)
    _assert_bf16(want, got)
    _assert_caches(rc, pc)
    want_f, _, _ = jax.jit(lambda p, t: ref_forward(
        p, {"tokens": t}, rcfg))(rp, jnp.asarray(toks))
    got_f, _, _ = forward(pp, {"tokens": torch.from_numpy(toks).long()}, cfg)
    _assert_bf16(want_f, got_f)
    step = jax.jit(lambda p, t, c, pos: ref_decode_step(p, t, c, pos, rcfg))
    tok = np.array(jnp.argmax(want[:, :cfg.vocab], -1), np.int32)
    pos = np.array([21, 21], np.int32)
    for _ in range(3):
        want, rc = step(rp, jnp.asarray(tok), rc, jnp.asarray(pos))
        got, pc = decode_step(pp, torch.from_numpy(tok).long(), pc,
                              torch.from_numpy(pos), cfg)
        _assert_bf16(want, got)
        _assert_caches(rc, pc)
        tok = np.array(jnp.argmax(want[:, :cfg.vocab], -1), np.int32)
        pos = pos + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_prefill_matches_reference(arch):
    rcfg, cfg, rp, pp, _ = _params(arch)
    prompt = _tokens(cfg, 1, 21, seed=1)
    rc = ref_init_cache(rcfg, 1, 24, staging=True)
    pc = init_cache(cfg, 1, 24, staging=True, device="cpu")
    step = jax.jit(lambda p, t, c, s, n: ref_chunk_prefill(p, t, c, s, n,
                                                           rcfg))
    for start, n in [(0, 8), (8, 8), (16, 5)]:
        buf = np.zeros((1, 8), np.int32)
        buf[0, :n] = prompt[0, start:start + n]
        want, rc = step(rp, jnp.asarray(buf), rc, jnp.int32(start),
                        jnp.int32(n))
        got, pc = chunk_prefill(pp, torch.from_numpy(buf).long(), pc, start,
                                n, cfg)
        _assert_bf16(want, got)
        _assert_caches(rc, pc)
    mono, _ = prefill(pp, {"tokens": torch.from_numpy(prompt).long()}, cfg,
                      24)
    np.testing.assert_allclose(_np(got), _np(mono), atol=BF16_TOL, rtol=0)
    assert int(got[0, :cfg.vocab].argmax()) == \
        int(mono[0, :cfg.vocab].argmax())


# -------------------------------------------------------------- repairs
@pytest.mark.parametrize("arch", ARCHS)
def test_slot_install_writes_every_recurrent_leaf(arch):
    """A batch-1 prefill cache installed into slot 1 lands whole: K/V
    rings and the Mamba, mLSTM and sLSTM states (the install used to copy
    attention entries only); the other slots stay zero."""
    _, cfg, _, pp, _ = _params(arch)
    one = prefill(pp, {"tokens": torch.from_numpy(_tokens(cfg, 1, 19)).long()},
                  cfg, MAX_SEQ)[1]
    arena = KVArena(cfg, 3, MAX_SEQ, device="cpu")
    arena.install(1, one, first_token=5, prompt_len=19)
    leaves, ones = _by_key(arena.caches), _by_key(one)
    assert set(leaves) == set(ones)
    for path, leaf in leaves.items():     # smoke stacks: the slot axis is 0
        torch.testing.assert_close(leaf[1:2], ones[path], rtol=0, atol=0)
        assert not leaf[0].any() and not leaf[2].any(), path
    assert any(p[-1] in ("h", "S", "c") for p in leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_stage_install_rings_attention_and_keeps_recurrent_state(arch):
    """Staging -> slot row: the windowed attention entries ring as the
    reference's do, recurrent state (a hybrid layer's Mamba entry, a whole
    mLSTM / sLSTM segment) passes through unchanged."""
    rcfg, cfg, _, _, _ = _params(arch)
    rng = np.random.default_rng(3)
    staging = jax.tree.map(
        lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype),
        ref_init_cache(rcfg, 1, 24, staging=True))
    want = ref_stage_install(rcfg, 24, MAX_SEQ)(staging, jnp.int32(21))
    port_staging = tree_map(lambda a: torch.from_numpy(np.array(
        jnp.asarray(a, jnp.float32))).to(
            torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32),
        staging)
    got = cached_stage_install(cfg, 24, MAX_SEQ)(port_staging, 21)
    assert set(_by_key(got)) == set(_by_key(want))
    for path, leaf in _by_key(want).items():
        np.testing.assert_array_equal(_np(_by_key(got)[path]), _np(leaf),
                                      err_msg=str(path))


# ---------------------------------------------------------------- engine
def _run(pkg, arch, lens, seed, chunk=0, budget=None):
    rcfg, cfg, rp, pp, _ = _params(arch)
    kw = dict(kv_slots=3, max_seq=MAX_SEQ)
    if pkg == "ref":
        eng = RefServingEngine(
            [RefEngineModel("a", rp, rcfg, **kw)],
            sched=RefSchedulerConfig(max_prefill_per_step=2,
                                     prefill_token_budget=budget),
            prefill_chunk=chunk)
    else:
        eng = ServingEngine(
            [EngineModel("a", pp, cfg, **kw)],
            sched=SchedulerConfig(max_prefill_per_step=2,
                                  prefill_token_budget=budget),
            prefill_chunk=chunk, device="cpu")
    rng = np.random.default_rng(seed)
    reqs = [eng.submit("a", rng.integers(1, cfg.vocab, int(n)).tolist(),
                       max_new_tokens=6) for n in lens]
    eng.run()
    return [(r.prompt, list(r.generated)) for r in reqs]


def _sequential(arch, prompt, n_new):
    """The reference's oracle: batch-1 monolithic prefill, then greedy
    decode at scalar positions."""
    rcfg, cfg, rp, _, _ = _params(arch)
    logits, caches = ref_prefill_step(rcfg, MAX_SEQ)(
        rp, {"tokens": jnp.asarray(prompt, jnp.int32)[None]})
    toks = [int(jnp.argmax(logits[0, :cfg.vocab]))]
    for i in range(n_new - 1):
        logits, caches = ref_serve_step(rcfg)(
            rp, jnp.asarray([toks[-1]], jnp.int32), caches,
            jnp.int32(len(prompt) + i))
        toks.append(int(jnp.argmax(logits[0, :cfg.vocab])))
    return toks


# `tests/test_chunked_prefill.py::test_hymba_hybrid_chunked_matches_
# monolithic`'s schedule: prompts of 24 and 30 tokens cross the window 16
HYMBA_LENS, HYMBA_SEED = (24, 7, 30, 18), 2


@pytest.mark.parametrize("chunk,budget", [(0, None), (8, None), (16, 8)],
                         ids=["monolithic", "chunk8", "chunk16-budget8"])
def test_hymba_engine_tokens_match_reference(chunk, budget):
    want = _run("ref", "hymba-1.5b", HYMBA_LENS, HYMBA_SEED, chunk, budget)
    got = _run("port", "hymba-1.5b", HYMBA_LENS, HYMBA_SEED, chunk, budget)
    assert got == want
    if chunk:
        assert got == _run("port", "hymba-1.5b", HYMBA_LENS, HYMBA_SEED)


def test_xlstm_engine_tokens_match_reference_loop():
    got = _run("port", "xlstm-350m", (21, 5, 33, 12), 4)
    for prompt, toks in got:
        assert toks == _sequential("xlstm-350m", list(prompt), 6), prompt


def test_mlstm_tenant_refuses_chunked_prefill():
    rcfg, cfg, rp, pp, _ = _params("xlstm-350m")
    with pytest.raises(ValueError, match="mLSTM") as want:
        RefServingEngine([RefEngineModel("a", rp, rcfg)], prefill_chunk=8)
    with pytest.raises(ValueError, match="mLSTM") as got:
        ServingEngine([EngineModel("a", pp, cfg)], prefill_chunk=8,
                      device="cpu")
    assert str(got.value) == str(want.value)
    ServingEngine([EngineModel("a", pp, cfg)], prefill_chunk=0, device="cpu")
    _, hcfg, _, hp, _ = _params("hymba-1.5b")
    ServingEngine([EngineModel("a", hp, hcfg)], prefill_chunk=8,
                  device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_arena_refuses_recurrent_stacks(arch):
    rcfg, cfg, _, _, _ = _params(arch)
    with pytest.raises(ValueError, match="pure-attention") as want:
        RefPagedKVArena(rcfg, 2, 8, 4)
    with pytest.raises(ValueError, match="pure-attention") as got:
        PagedKVArena(cfg, 2, 8, 4, device="cpu")
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------------- CLI
@pytest.mark.parametrize("arch", ARCHS)
def test_default_mode_matches_reference_cli(arch, capsys, monkeypatch):
    """`--arch <arch> --smoke`: `make_batch`'s 4 x 12 tokens, 4 greedy
    steps; the printed token ids equal the reference CLI's."""
    argv = ["--arch", arch, "--smoke", "--prompt-len", "12", "--gen", "5"]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    ref_serve.main()
    want_out = capsys.readouterr().out.splitlines()[-1]
    args = serve._parser().parse_args([*argv, "--device", "cpu"])
    toks, _, _ = serve.run_greedy(args, params=_params(arch)[3])
    assert capsys.readouterr().out.splitlines()[-1] == want_out
    assert toks.shape == (4, 5)


def _cli_engine(pkg, tmp_path, monkeypatch):
    """One `--arch hymba-1.5b --engine --smoke --virtual-clock` run of
    either CLI (two tenants, tenant-b the perturbed variant), with its
    trace and metrics files; the exit hooks are recorded, not
    installed.  Returns (trace, metrics document)."""
    import atexit
    import signal
    monkeypatch.setattr(atexit, "register", lambda fn: None)
    monkeypatch.setattr(signal, "signal", lambda *a: None)
    out = tmp_path / pkg
    out.mkdir()
    argv = ["--arch", "hymba-1.5b", "--engine", "--smoke", "--virtual-clock",
            "--requests", "6", "--prompt-len", "20", "--gen", "5",
            "--turn-steps", "2", "--trace-out", str(out / "trace.json"),
            "--metrics-json", str(out / "metrics.json")]
    if pkg == "ref":
        seen = {}
        monkeypatch.setattr(ref_serve, "_run_engine",
                            lambda args: seen.setdefault("args", args))
        monkeypatch.setattr(sys, "argv", ["serve", *argv])
        ref_serve.main()
        monkeypatch.undo()
        monkeypatch.setattr(atexit, "register", lambda fn: None)
        monkeypatch.setattr(signal, "signal", lambda *a: None)
        ref_serve._run_engine(seen["args"])
    else:
        serve._run_engine(serve._parser().parse_args([*argv, "--device",
                                                      "cpu"]),
                          params=_params("hymba-1.5b")[4])
    return (json.loads((out / "trace.json").read_text()),
            json.loads((out / "metrics.json").read_text()))


def test_hymba_engine_cli_matches_reference(tmp_path, monkeypatch, capsys):
    """The CLI's two-tenant slot engine on the reference's weights (f32,
    so the weight store quantizes the same values): trace and metrics
    equal the reference CLI's but for the process-wide step-cache
    counters."""
    ref_trace, ref_doc = _cli_engine("ref", tmp_path, monkeypatch)
    trace, doc = _cli_engine("port", tmp_path, monkeypatch)
    assert "finished 6" in capsys.readouterr().out
    assert trace == ref_trace

    def strip(summary):
        return {k: v for k, v in summary.items()
                if not k.startswith("prefill_cache_")}
    assert strip(doc["summary"]) == strip(ref_doc["summary"])
    assert doc["metrics"] == ref_doc["metrics"]
