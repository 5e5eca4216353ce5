"""The reference's two non-token input modes on the port, against the
reference on the CPU at smoke size:

  * `make_batch`: an embeddings model's frame embeddings, targets and
    loss mask, and a prefix VLM's tokens and patch embeddings, bit-equal
    to the reference's for several (seed, step) pairs;
  * `supported_shapes` equal to the reference's on every arch;
  * `init_params` and the weight bridge: hubert-xlarge's untied head and
    ungated MLP, paligemma-3b's single KV head and tied embeddings;
  * hubert-xlarge (an encoder, `causal=False`): the forward's logits on
    the batch dict within 2e-2 of the reference's at S 16 (its
    `_softmax_attend`) and S 1,100 (its `chunked_attention`), every layer
    through the flash wrapper's non-causal mode;
  * paligemma-3b (256 image-prefix positions at full width, 4 at smoke):
    the prefill's logits and caches on the batch dict within 2e-2 of the
    reference's, at S + P 16 (the masked softmax with the prefix term)
    and S + P 1,104 (`chunked_attention` with it), no flash launch; one
    `decode_step` at position S + P over the prefill's cache; the
    launcher's default mode on bridged weights gives the reference loop's
    tokens bit for bit, and the reference CLI's printed ones;
  * the streaming executor on both batch dicts: the reference executor's
    installs, stats and metrics, logits within 2e-2 of its logit scale
    (hubert non-causal; paligemma with the prefix dropped, as the
    reference's executor drops it: its image positions attend causally);
  * the CLI's encoder exit and the engine's refusal of both families,
    word for word as the reference's.
"""
import dataclasses as dc
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.configs import supported_shapes as ref_supported_shapes
from repro.kernels.delta_apply import ops as ref_delta_ops
from repro.kernels.delta_apply.ref import delta_apply_ref
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import make_batch as ref_make_batch
from repro.launch import serve as ref_serve
from repro.launch.steps import cached_prefill_step as ref_prefill_step
from repro.launch.steps import cached_serve_step as ref_serve_step
from repro.nn.model import forward as ref_forward
from repro.nn.model import init_params as ref_init_params
from repro.serving import EngineModel as RefEngineModel
from repro.serving import ServingEngine as RefServingEngine
from repro.streaming import plan as ref_plan
from repro.streaming.executor import StreamingExecutor as RefExecutor
from repro_torch.configs import ARCHS, get_config, supported_shapes
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import serve
from repro_torch.nn import attention as attn_mod
from repro_torch.nn.model import decode_step, forward, init_params, prefill
from repro_torch.serving import EngineModel, ServingEngine
from repro_torch.streaming import plan
from repro_torch.streaming.executor import StreamingExecutor
from repro_torch.tree import tree_map
from repro_torch.weights import params_from_reference

HUBERT, PALIGEMMA = "hubert-xlarge", "paligemma-3b"
MODES = (HUBERT, PALIGEMMA)
BF16_TOL = 2e-2
_PARAMS = {}


def _params(arch):
    """(reference cfg, port cfg, reference params for PRNGKey(0), port
    params through the bridge)."""
    if arch not in _PARAMS:
        rcfg, cfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
        ref = ref_init_params(jax.random.PRNGKey(0), rcfg)
        _PARAMS[arch] = (rcfg, cfg, ref, params_from_reference(
            jax.tree.map(np.asarray, ref), cfg, device="cpu"))
    return _PARAMS[arch]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _batches(cfg, seq_len, batch, step=0):
    """`make_batch`'s batch as the reference takes it (jnp) and as the
    port takes it (torch), from the port's arrays."""
    np_batch = make_batch(cfg, DataConfig(seq_len, batch), step)
    return ({k: jnp.asarray(v) for k, v in np_batch.items()},
            {k: torch.from_numpy(v) for k, v in np_batch.items()})


def _flash_calls(monkeypatch):
    """Record the `causal` flag of every flash wrapper call the model
    makes (the wrapper then runs as it would)."""
    calls = []
    real = attn_mod.flash_attention

    def recording(q, k, v, causal=True):
        calls.append(causal)
        return real(q, k, v, causal=causal)
    monkeypatch.setattr(attn_mod, "flash_attention", recording)
    return calls


def _assert_bf16(want, got):
    """Within the reference kernel tests' bf16 tolerance, rtol = atol =
    2e-2 (`tests/test_kernels.py`): a bf16 ulp apart passes at any
    magnitude, a missed mask or prefix term does not."""
    np.testing.assert_allclose(_np(got), _np(want), atol=BF16_TOL,
                               rtol=BF16_TOL)


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("seed,step", [(1234, 0), (1234, 7), (0, 0),
                                       (99, 123456)])
@pytest.mark.parametrize("arch", MODES)
def test_make_batch_matches_reference(arch, seed, step):
    got = make_batch(get_config(arch, smoke=True), DataConfig(9, 3, seed),
                     step)
    want = ref_make_batch(ref_config(arch, smoke=True),
                          RefDataConfig(9, 3, seed), step)
    assert set(got) == set(want)
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype and \
            got[name].shape == arr.shape, name
        np.testing.assert_array_equal(got[name], arr, err_msg=name)


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_supported_shapes_match_reference(arch):
    assert arch in ARCHS
    assert supported_shapes(arch) == ref_supported_shapes(arch)


# ---------------------------------------------------------------- init
@pytest.mark.parametrize("arch", MODES)
def test_init_and_bridge_carry_each_family_tree(arch):
    """hubert: an untied (d_model, vocab_padded) head beside the table and
    no w_gate; paligemma: K/V projections of one head of 16 (smoke) and no
    head.  Both `init_params` and the bridge give the reference's shapes
    and the bridge its values, rounded to bf16."""
    rcfg, cfg, ref, port = _params(arch)
    mine = init_params(cfg, seed=0, device="cpu")
    seg = ref["stack"]["segments"][0]
    for tree in (port, mine):
        emb, block = tree["embedding"], tree["stack"]["segments"][0]
        assert ("head" in emb) == (not cfg.tie_embeddings)
        assert ("w_gate" in block["mlp"]) == cfg.gated
        for name in ("table", "head"):
            if name in emb:
                assert tuple(emb[name].shape) == \
                    tuple(ref["embedding"][name].shape), name
        for name, leaf in seg["attn"].items():
            assert tuple(block["attn"][name].shape) == tuple(leaf.shape)
    if arch == HUBERT:
        assert not cfg.tie_embeddings and not cfg.gated
        assert tuple(port["embedding"]["head"].shape) == \
            (cfg.d_model, cfg.vocab_padded)
    else:
        assert cfg.tie_embeddings and cfg.n_kv_heads == 1
        assert tuple(port["stack"]["segments"][0]["attn"]["w_k"].shape) == \
            (cfg.d_model, cfg.head_dim)
    want = np.asarray(ref["embedding"]["table"].astype(jnp.bfloat16)
                      .astype(jnp.float32))
    np.testing.assert_array_equal(_np(port["embedding"]["table"]), want)


# -------------------------------------------------------------- hubert
@pytest.mark.parametrize("seq_len", [16, 1100])
def test_hubert_forward_matches_reference(seq_len, monkeypatch):
    """The encoder's whole-sequence logits on `make_batch`'s embeddings
    batch within 2e-2 of the reference's (S 1,100 is past its 1,024-token
    masked softmax: its `chunked_attention`), every layer through the
    flash wrapper with causal=False (its plain version on the CPU)."""
    rcfg, cfg, ref, port = _params(HUBERT)
    r_batch, t_batch = _batches(cfg, seq_len, 1 if seq_len > 1024 else 2)
    want, _, _ = jax.jit(ref_forward, static_argnums=2)(
        ref, {"embeds": r_batch["embeds"]}, rcfg)
    calls = _flash_calls(monkeypatch)
    got, caches, _ = forward(port, t_batch, cfg)
    assert calls == [False] * cfg.n_layers
    assert caches is None and got.shape == want.shape
    _assert_bf16(want, got)


# ----------------------------------------------------------- paligemma
@pytest.mark.parametrize("seq_len,batch", [(12, 2), (1100, 1)])
def test_paligemma_prefill_and_decode_match_reference(seq_len, batch,
                                                      monkeypatch):
    """The prefill of `make_batch`'s tokens behind its P patch embeddings
    into a cache of S + P + 2, no flash launch (the kernel has no prefix
    term): logits and K/V within 2e-2 of the reference's (at S + P 1,104
    both run `chunked_attention` with the prefix term); then one
    `decode_step` of the greedy token at position S + P over that cache,
    its logits within 2e-2 of the reference's decode."""
    rcfg, cfg, ref, port = _params(PALIGEMMA)
    P = cfg.prefix_len
    L = seq_len + P + 2
    r_batch, t_batch = _batches(cfg, seq_len, batch, step=3)
    want, r_cache = ref_prefill_step(rcfg, L)(ref, r_batch)
    calls = _flash_calls(monkeypatch)
    chunked = []
    real_chunked = attn_mod.chunked_attention

    def recording(*a, **kw):
        chunked.append(kw["prefix_len"])
        return real_chunked(*a, **kw)
    monkeypatch.setattr(attn_mod, "chunked_attention", recording)
    got, t_cache = prefill(port, t_batch, cfg, L)
    assert calls == []
    assert chunked == ([P] * cfg.n_layers if seq_len + P > 1024 else [])
    _assert_bf16(want, got)
    for g, w in zip(t_cache, r_cache):
        for name in ("k", "v"):
            assert tuple(g["attn"][name].shape) == w["attn"][name].shape
            _assert_bf16(w["attn"][name], g["attn"][name])
    tok = np.array(jnp.argmax(want, -1), np.int32)
    r_out, _ = ref_serve_step(rcfg)(ref, jnp.asarray(tok), r_cache,
                                    jnp.int32(seq_len + P))
    t_out, _ = decode_step(port, torch.from_numpy(tok).long(), t_cache,
                           seq_len + P, cfg)
    _assert_bf16(r_out, t_out)


def test_paligemma_default_mode_matches_reference(capsys, monkeypatch):
    """`--arch paligemma-3b --smoke` (4 x 12 tokens behind 4 patch
    positions, 5 new) on bridged weights: the tokens equal the reference's
    prefill-then-decode loop at positions 16 + i bit for bit, and the
    printed token ids the reference CLI's."""
    rcfg, cfg, ref, port = _params(PALIGEMMA)
    argv = ["--arch", PALIGEMMA, "--smoke", "--prompt-len", "12", "--gen",
            "5"]
    args = serve._parser().parse_args([*argv, "--device", "cpu"])
    toks, _, _ = serve.run_greedy(args, params=port)
    got_out = capsys.readouterr().out.splitlines()[-1]
    batch = {k: jnp.asarray(v) for k, v in ref_make_batch(
        rcfg, RefDataConfig(12, 4), 0).items()}
    pos = 12 + rcfg.prefix_len
    logits, caches = ref_prefill_step(rcfg, pos + 5)(ref, batch)
    want = [jnp.argmax(logits, -1).astype(jnp.int32)]
    for i in range(4):
        logits, caches = ref_serve_step(rcfg)(ref, want[-1], caches,
                                              jnp.int32(pos + i))
        want.append(jnp.argmax(logits, -1).astype(jnp.int32))
    np.testing.assert_array_equal(toks, np.stack([np.asarray(t)
                                                  for t in want], 1))
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    ref_serve.main()
    assert got_out == capsys.readouterr().out.splitlines()[-1]


# -------------------------------------------------------------- refusals
def test_cli_exits_for_the_encoder(monkeypatch):
    """`--arch hubert-xlarge`, in any mode: the reference CLI's exit, word
    for word, before a mode runs."""
    for mode in ([], ["--engine"], ["--streaming"]):
        argv = ["serve", "--arch", HUBERT, "--smoke", *mode]
        monkeypatch.setattr(sys, "argv", argv)
        with pytest.raises(SystemExit) as want:
            ref_serve.main()
        monkeypatch.setattr(sys, "argv", [*argv, "--device", "cpu"])
        with pytest.raises(SystemExit) as got:
            serve.main()
        assert str(got.value) == str(want.value) == \
            "hubert-xlarge is encoder-only: no decode path"


@pytest.mark.parametrize("arch", MODES)
def test_engine_refuses_the_input_modes(arch):
    rcfg, cfg, ref, port = _params(arch)
    with pytest.raises(ValueError) as want:
        RefServingEngine([RefEngineModel(arch, ref, rcfg)])
    with pytest.raises(ValueError) as got:
        ServingEngine([EngineModel(arch, port, cfg)], device="cpu")
    assert str(got.value) == str(want.value) == \
        f"{arch}: engine serves causal token LMs"


def test_non_token_configs_keep_their_modes():
    """The full configs as the reference states them: hubert an encoder
    over embeddings, paligemma 256 prefix positions."""
    h, p = get_config(HUBERT), get_config(PALIGEMMA)
    assert (h.input_mode, h.causal, h.is_encoder) == ("embeddings", False,
                                                      True)
    assert (p.input_mode, p.prefix_len, p.causal) == ("prefix_vlm", 256,
                                                      True)
    assert dc.asdict(h) == dc.asdict(ref_config(HUBERT))
    assert dc.asdict(p) == dc.asdict(ref_config(PALIGEMMA))


# ------------------------------------------------------------ streaming
# the link both executors model (`tests/test_torch_streaming.py`)
LINK = dict(peak_flops=1e14, hbm_bw=1e12, dma_bw=2e10, dma_latency_s=2e-5)


@pytest.mark.parametrize("arch", MODES)
def test_streaming_executor_matches_reference(arch, monkeypatch):
    """One forward of each executor through 2 arena slots over the same
    `make_batch` dict (the reference's `apply_delta` on its `ref`, never
    Pallas interpret): equal stats and metrics, logits within 2e-2 of the
    logit scale (the reference's per-layer jit rounds elsewhere than the
    whole-model jit; `tests/test_torch_streaming.py`).  Every layer goes
    through the flash wrapper: hubert's non-causal, paligemma's causal,
    since the executor drops `_inputs_to_x`'s prefix as the reference's
    does; so paligemma's streamed logits part from the resident
    forward's, which keeps the prefix term."""
    rcfg, cfg, ref, _ = _params(arch)
    r_batch, t_batch = _batches(cfg, 10, 2, step=5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_delta_ops, "apply_delta", delta_apply_ref)
        rex = RefExecutor(ref, rcfg, arena_slots=2, plan_tokens=20,
                          link=ref_plan.TpuLinkModel(**LINK))
        r_logits, r_m = rex.forward(r_batch)
    f32 = tree_map(lambda a: torch.from_numpy(np.array(a)),
                   jax.tree.map(np.asarray, ref))
    ex = StreamingExecutor(f32, cfg, arena_slots=2, plan_tokens=20,
                           link=plan.LinkModel(**LINK), device="cpu")
    calls = _flash_calls(monkeypatch)
    logits, m = ex.forward(t_batch)
    assert calls == [cfg.causal] * cfg.n_layers
    assert dc.asdict(ex.stats) == dc.asdict(rex.stats)
    for k, v in r_m.items():
        if k != "wall_s":
            assert m[k] == v, k
    want, got = _np(r_logits), _np(logits)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL * scale)
    if arch == PALIGEMMA:
        assert got.shape[1] == 10 + cfg.prefix_len
        with_prefix, _, _ = forward(f32, t_batch, cfg)
        assert np.abs(_np(with_prefix) - want).max() > BF16_TOL * scale
