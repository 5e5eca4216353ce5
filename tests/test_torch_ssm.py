"""The port's recurrent cells and windowed prefill attention against the
reference on the CPU, on seeded numpy inputs:

  * `mamba` (hymba smoke's layer 0), `mlstm` and `slstm` (xlstm smoke's
    layers 0 and 1), each in three modes against the reference's jitted
    cell: a prefill with its final state, three decode steps from that
    state, and a chunk continuation of 8 tokens of which 5 are valid.
    The bf16 outputs are bit-equal but for a few elements one ulp off (an
    f32 ulp of XLA's and torch's exp, sigmoid, tanh or sums flipping a
    rounding), held within 2e-2 (`tests/test_kernels.py:94`); recurrent
    states within 3e-4, the conv window's bf16 inputs as the outputs;
  * `chunked_attention` at S > 1024 against the reference's: banded at
    windows 48 and 1024 (`_banded_attention`) and the online softmax with
    a logit softcap, within 2e-4 (`tests/test_attention.py:56-62`);
  * a windowed monolithic prefill over 1,024 tokens through `attention`:
    the reference's output within 2e-2, and no S×S mask built.
"""
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.nn import attention as ref_attention_mod
from repro.nn import ssm as ref_ssm
from repro.nn.model import init_params as ref_init_params
from repro_torch.configs import get_config
from repro_torch.nn import attention as attention_mod
from repro_torch.nn import ssm
from repro_torch.weights import params_from_reference

BF16_TOL = 2e-2
STATE_TOL = 3e-4
ATTN_TOL = 2e-4
# cell -> (arch, layer index of the smoke model that holds it, params key)
CELLS = {"mamba": ("hymba-1.5b", 0, "mamba"),
         "mlstm": ("xlstm-350m", 0, "cell"),
         "slstm": ("xlstm-350m", 1, "cell")}
MAX_ULP_SHARE = 0.01
_PARAMS = {}


def _cell(name):
    """(reference cfg, port cfg, reference cell params, port cell params,
    reference cell fn, port cell fn)."""
    arch, layer, key = CELLS[name]
    if arch not in _PARAMS:
        rcfg = ref_config(arch, smoke=True)
        cfg = get_config(arch, smoke=True)
        ref = ref_init_params(jax.random.PRNGKey(0), rcfg)
        _PARAMS[arch] = (rcfg, cfg, ref, params_from_reference(
            jax.tree.map(np.asarray, ref), cfg, device="cpu"))
    rcfg, cfg, ref, port = _PARAMS[arch]
    return (rcfg, cfg, ref["stack"]["segments"][layer][key],
            port["stack"]["segments"][layer][key],
            getattr(ref_ssm, name), getattr(ssm, name))


def _x(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_out(want, got):
    """bf16 outputs within BF16_TOL, and bit-equal but for at most
    MAX_ULP_SHARE of the elements: an f32 ulp left by XLA's and torch's
    transcendentals and sums flips a bf16 rounding now and then, while a
    rounding point the port missed moves many more."""
    a, b = _np(got), _np(want)
    np.testing.assert_allclose(a, b, atol=BF16_TOL, rtol=0)
    assert (a != b).mean() <= MAX_ULP_SHARE, (a != b).mean()


def _assert_state(want, got):
    """f32 states within STATE_TOL; Mamba's conv window holds bf16 inputs
    of the cell, held as its outputs are."""
    assert set(got) == set(want)
    for k in want:
        if k == "conv":
            _assert_out(want[k], got[k])
        else:
            np.testing.assert_allclose(_np(got[k]), _np(want[k]),
                                       atol=STATE_TOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("mode", ["prefill", "decode", "chunk"])
@pytest.mark.parametrize("name", list(CELLS))
def test_cell_matches_reference(name, mode):
    rcfg, cfg, rp, pp, rfn, pfn = _cell(name)
    rng = np.random.default_rng(7)
    xj, xt = _x(rng, 2, 13, cfg.d_model)
    prefill = jax.jit(lambda p, x: rfn(p, x, rcfg, make_cache=True))
    want, rcache = prefill(rp, xj)
    got, pcache = pfn(pp, xt, cfg, make_cache=True)
    _assert_out(want, got)
    _assert_state(rcache, pcache)
    if mode == "decode":
        step = jax.jit(lambda p, x, c: rfn(p, x, rcfg, cache=c))
        for _ in range(3):
            xj, xt = _x(rng, 2, 1, cfg.d_model)
            want, rcache = step(rp, xj, rcache)
            got, pcache = pfn(pp, xt, cfg, cache=pcache)
            _assert_out(want, got)
            _assert_state(rcache, pcache)
    elif mode == "chunk":
        step = jax.jit(lambda p, x, c, n: rfn(p, x, rcfg, cache=c,
                                              valid_len=n))
        xj, xt = _x(rng, 2, 8, cfg.d_model)
        want, rcache = step(rp, xj, rcache, jnp.int32(5))
        got, pcache = pfn(pp, xt, cfg, cache=pcache, valid_len=5)
        _assert_out(want, got)
        _assert_state(rcache, pcache)


# ------------------------------------------------------ chunked attention
@pytest.mark.parametrize("window,softcap", [(48, 0.0), (1024, 0.0),
                                            (0, 30.0)],
                         ids=["window48", "window1024", "softcap"])
def test_chunked_attention_matches_reference(window, softcap):
    rng = np.random.default_rng(window + 3)
    S, Hkv, G, D = 1100, 1, 2, 8
    q = rng.standard_normal((1, S, Hkv, G, D)).astype(np.float32)
    k, v = (rng.standard_normal((1, S, Hkv, D)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=True, window=window, softcap=softcap, q_chunk=512,
              kv_chunk=1024)
    want = jax.jit(lambda q, k, v: ref_attention_mod.chunked_attention(
        q, k, v, **kw))(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    got = attention_mod.chunked_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), **kw)
    assert got.shape == (1, S, Hkv, G, D)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATTN_TOL, rtol=0)


def test_windowed_prefill_over_1024_tokens_builds_no_full_mask(monkeypatch):
    """hymba smoke's attention at window 48 over 1,100 tokens: the banded
    route, never an S×S mask, and the reference's output."""
    rcfg = dc.replace(ref_config("hymba-1.5b", smoke=True), sliding_window=48)
    cfg = dc.replace(get_config("hymba-1.5b", smoke=True), sliding_window=48)
    rp = ref_init_params(jax.random.PRNGKey(1), rcfg)
    pp = params_from_reference(jax.tree.map(np.asarray, rp), cfg,
                               device="cpu")
    layer = 1                           # smoke's windowed layer
    assert cfg.window_for_layer(layer) == 48
    xj, xt = _x(np.random.default_rng(11), 1, 1100, cfg.d_model)
    masks = []
    real_mask = attention_mod._mask

    def recording_mask(qpos, kpos, **kw):
        out = real_mask(qpos, kpos, **kw)
        masks.append(tuple(out.shape))
        return out
    monkeypatch.setattr(attention_mod, "_mask", recording_mask)
    want, _ = jax.jit(lambda p, x: ref_attention_mod.attention(
        p, x, rcfg, layer_window=48))(
            rp["stack"]["segments"][layer]["attn"], xj)
    got, _ = attention_mod.attention(
        pp["stack"]["segments"][layer]["attn"], xt, cfg, layer_window=48)
    assert masks and all(m[-2:] != (1100, 1100) for m in masks), masks
    np.testing.assert_allclose(_np(got), _np(want), atol=BF16_TOL, rtol=0)
