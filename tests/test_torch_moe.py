"""The port's MoE layer (`repro_torch.nn.moe`) against the reference's
no-mesh path (`repro.nn.moe.moe_reference`, what `moe` runs without a
mesh) on the CPU, with the reference's `init_moe` weights carried over
(router in f32, expert stacks in bf16):

  * `_route`: the same top-k expert indices, in the same (descending)
    order, gates within 1e-6; `_aux_loss` within 1e-6;
  * `moe_reference` (the reference's loop over the experts) with and
    without shared experts, at deepseek-v2-lite's and qwen3-moe's smoke
    widths, within the bf16 tolerance 2e-2 (`tests/test_kernels.py:94`);
    torch's and XLA's f32 softmax can differ by an ulp in a gate, which
    moves a rare output by one bf16 ulp;
  * `moe` (experts stacked, token chunks, the expert-order sum as a scan)
    bit for bit equal to `moe_reference`, at one and at several chunks;
  * a whole MoE block of deepseek-v2-lite (MLA) and of qwen3-moe (GQA,
    qk_norm) smoke, layer by layer, against the reference's jitted
    `apply_block`: residual stream within 2e-2 and the aux loss within
    1e-6.
"""
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.nn import moe as ref_moe
from repro.nn.model import init_params as ref_init_params
from repro.nn.transformer import apply_block as ref_apply_block
from repro_torch.configs import get_config
from repro_torch.nn import moe
from repro_torch.nn.model import F32_LEAVES
from repro_torch.nn.transformer import apply_block
from repro_torch.weights import params_from_reference

MOE_ARCHS = ("deepseek-v2-lite-16b", "qwen3-moe-235b-a22b")
BF16_TOL = 2e-2


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _layer(arch, shared=True, seed=3):
    """(reference config, port config, reference `init_moe` params, port
    params through the weight bridge)."""
    rcfg = ref_config(arch, smoke=True)
    if not shared:
        rcfg = dc.replace(rcfg, n_shared_experts=0)
    cfg = dc.replace(get_config(arch, smoke=True),
                     n_shared_experts=rcfg.n_shared_experts)
    ref = ref_moe.init_moe(jax.random.PRNGKey(seed), rcfg)
    return rcfg, cfg, ref, _bridge(jax.tree.map(np.asarray, ref))


def _bridge(node, key=None):
    """One layer's numpy leaves as the weight bridge stores them: the
    `F32_LEAVES` (the router) in f32, the matrices in bf16."""
    if isinstance(node, dict):
        return {k: _bridge(v, k) for k, v in node.items()}
    return torch.from_numpy(np.array(node)).to(
        torch.float32 if key in F32_LEAVES else torch.bfloat16)


def _x(cfg, T, seed):
    x = np.random.default_rng(seed).standard_normal(
        (2, T, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("T", [1, 19])
def test_route_and_aux_loss_match_reference(arch, T):
    rcfg, cfg, ref, port = _layer(arch)
    jx, tx = _x(cfg, T, seed=T)
    xf = jx.reshape(-1, cfg.d_model).astype(jnp.float32)
    probs, gv, gi = jax.jit(ref_moe._route, static_argnums=2)(
        xf, ref["router"], rcfg.moe_topk)
    t_probs, t_gv, t_gi = moe._route(tx.reshape(-1, cfg.d_model).float(),
                                     port["router"], cfg.moe_topk)
    np.testing.assert_array_equal(t_gi.numpy(), np.asarray(gi))
    np.testing.assert_allclose(t_gv.numpy(), np.asarray(gv), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(t_probs.numpy(), np.asarray(probs), rtol=0,
                               atol=1e-6)
    assert (np.diff(t_gv.numpy(), axis=-1) <= 0).all()   # descending
    aux = ref_moe._aux_loss(probs, gi, rcfg.n_experts)
    t_aux = moe._aux_loss(t_probs, t_gi, cfg.n_experts)
    assert abs(float(t_aux) - float(aux)) < 1e-6


@pytest.mark.parametrize("arch,shared", [
    ("deepseek-v2-lite-16b", True), ("deepseek-v2-lite-16b", False),
    ("qwen3-moe-235b-a22b", False)],
    ids=["deepseek-shared", "deepseek-no-shared", "qwen3-moe"])
@pytest.mark.parametrize("T", [1, 8, 37])
def test_moe_reference_matches_reference(arch, shared, T):
    rcfg, cfg, ref, port = _layer(arch, shared)
    assert bool(rcfg.n_shared_experts) == shared
    jx, tx = _x(cfg, T, seed=T + 7)
    want, want_aux = jax.jit(ref_moe.moe_reference, static_argnums=2)(
        ref, jx, rcfg)
    got, got_aux = moe.moe_reference(port, tx, cfg)
    assert got.dtype == torch.bfloat16 and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_TOL,
                               atol=BF16_TOL)
    assert abs(float(got_aux) - float(want_aux)) < 1e-6
    # the stacked form is the same function, bit for bit
    stacked, stacked_aux = moe.moe(port, tx, cfg)
    np.testing.assert_array_equal(_np(stacked), _np(got))
    assert float(stacked_aux) == float(got_aux)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_token_chunks_change_nothing(arch, monkeypatch):
    """`moe` evaluates the experts over token chunks that bound the
    (E, tokens, d) activations: a chunk of 5 tokens gives the one-chunk
    result bit for bit."""
    _, cfg, _, port = _layer(arch)
    _, tx = _x(cfg, 23, seed=5)
    whole, _ = moe.moe(port, tx, cfg)
    monkeypatch.setattr(moe, "CHUNK_BYTES",
                        5 * 4 * cfg.n_experts * max(cfg.d_model,
                                                    cfg.d_ff_expert))
    chunked, _ = moe.moe(port, tx, cfg)
    np.testing.assert_array_equal(_np(chunked), _np(whole))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_blocks_match_reference(arch):
    """Every MoE block of the smoke model (deepseek's layer 1 after its
    dense layer 0; qwen3-moe's stacked layers) on a random bf16 residual
    stream: the block's output within the bf16 tolerance and its aux loss
    within 1e-6 of the reference's jitted block."""
    rcfg = ref_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    ref = ref_init_params(jax.random.PRNGKey(0), rcfg)
    port = params_from_reference(jax.tree.map(np.asarray, ref), cfg,
                                 device="cpu")
    jx, tx = _x(cfg, 9, seed=2)
    block = jax.jit(ref_apply_block, static_argnums=(2, 3))
    checked = 0
    for seg, (rseg, tseg) in enumerate(zip(ref["stack"]["segments"],
                                           port["stack"]["segments"])):
        scanned = rseg["norm1"]["scale"].ndim == 2
        n = rseg["norm1"]["scale"].shape[0] if scanned else 1
        for li in range(n):
            i = seg if not scanned else li
            if not rcfg.layer_is_moe[i]:
                continue
            rbp = jax.tree.map(lambda a: a[li], rseg) if scanned else rseg
            tbp = ({k: _index(v, li) for k, v in tseg.items()} if scanned
                   else tseg)
            want, _, want_aux = block(rbp, jx, rcfg, i)
            got, _, got_aux = apply_block(tbp, tx, cfg, i)
            np.testing.assert_allclose(_np(got.to(torch.bfloat16)),
                                       _np(want), rtol=BF16_TOL,
                                       atol=BF16_TOL)
            assert abs(float(got_aux) - float(want_aux)) < 1e-6
            checked += 1
    assert checked == sum(cfg.layer_is_moe)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]
