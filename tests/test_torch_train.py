"""The port's training path against the reference on minicpm-2b and
gemma-7b smoke, on the reference trainer's own params (bf16 for every
float leaf of two or more dims) and `make_batch`'s batch: `lm_loss` within
1e-4 relative; every gradient leaf within 3e-2 in relative norm (bf16
activations; the reference differentiates its masked softmax, the port the
flash Function); AdamW on the reference's gradients (moments within 1e-6
relative, params equal but for a bf16 ulp); the cosine and WSD schedules
over many steps; one `make_train_step` step; and the reference smoke
test's two-step "loss does not rise" check."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.steps import make_train_step as ref_make_train_step
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.optim.adamw import adamw_update as ref_adamw_update
from repro.optim.schedules import cosine as ref_cosine
from repro.optim.schedules import wsd as ref_wsd
import repro_torch.serving  # noqa: F401  (before launch.steps)
from repro_torch.launch.steps import make_train_step
from repro_torch.nn.model import lm_loss
from repro_torch.optim import adamw_init, adamw_update, cosine, wsd
from repro_torch.tree import tree_flatten

from train_pair import (batches, configs, grad_rel_errors, ref_loss_and_grads,
                        ref_params, to_numpy_f32, to_torch)

ARCHS = ["minicpm-2b", "gemma-7b"]
GRAD_TOL = 3e-2


@pytest.mark.parametrize("arch", ARCHS + ["minicpm-2b@5"])
def test_lm_loss_and_every_gradient_leaf(arch):
    """minicpm-2b@5: five layers, a stacked segment the reference scans
    and the port runs layer by layer from one unbind per leaf."""
    params = to_torch(ref_params(arch))
    errs, (loss_p, met_p), (loss_r, met_r) = grad_rel_errors(arch, params)
    assert abs(loss_p - loss_r) <= 1e-4 * abs(loss_r), (loss_p, loss_r)
    assert abs(met_p["ce"] - met_r["ce"]) <= 1e-4 * abs(met_r["ce"])
    assert met_p["tokens"] == met_r["tokens"] == 2 * 15
    assert met_p["aux"] == met_r["aux"] == 0.0
    assert max(errs) <= GRAD_TOL, sorted(errs)[-5:]


def _bf16_ulps(a: torch.Tensor, b: np.ndarray) -> int:
    """The largest distance in bf16 steps between two bf16 arrays."""
    bits_a = a.view(torch.int16).numpy().astype(np.int32)
    bits_b = b.view(np.int16).astype(np.int32)
    return int(np.max(np.abs(bits_a - bits_b)))


@pytest.mark.parametrize("clipped", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_on_the_reference_gradients(arch, clipped):
    """Two AdamW steps, each package on the reference's own gradients:
    scaled by 0.1 (global norm ~0.4, under the clip of 1: the moments
    see the gradients as they are) and as they are (norm ~4, clipped).
    Clipping divides by the global norm, whose f32 sum each framework
    orders its own way; the port's must be as close to the f64 norm as
    the reference's, and the second moment, which scales with its
    inverse square, may differ by twice the two norms' gap."""
    _, _, grads = ref_loss_and_grads(arch)
    if not clipped:
        grads = jax.tree.map(lambda g: (g * 0.1).astype(g.dtype), grads)
    flat_g = [np.asarray(g.astype(jnp.float32), np.float64)
              for g in jax.tree.leaves(grads)]
    exact = np.sqrt(sum(np.sum(g * g) for g in flat_g))
    assert (exact > 1.0) == clipped
    rp = ref_params(arch)
    ropt = ref_adamw_init(rp)
    pp = to_torch(rp)
    popt = adamw_init(pp)
    pg = to_torch(grads)
    for lr in (1e-3, 3e-3):
        rp, ropt, rm = ref_adamw_update(rp, grads, ropt, jnp.float32(lr))
        pp, popt, pm = adamw_update(pp, pg, popt, lr)
    assert int(popt.step) == int(ropt.step) == 2
    gn, gn_r = float(pm["grad_norm"]), float(rm["grad_norm"])
    assert abs(gn - gn_r) <= 1e-6 * gn_r, (gn, gn_r)
    assert abs(gn - exact) <= abs(gn_r - exact) + 1e-7 * exact
    gap = abs(gn - gn_r) / gn_r if clipped else 0.0
    for mine, ref, tol in ((popt.mu, ropt.mu, 1e-6 + gap),
                           (popt.nu, ropt.nu, 1e-6 + 2 * gap)):
        for a, b in zip(tree_flatten(mine), jax.tree.leaves(ref)):
            b = np.asarray(b)
            err = np.max(np.abs(a.numpy() - b))
            assert err <= tol * max(np.max(np.abs(b)), 1e-30), err
    for a, b in zip(tree_flatten(pp), jax.tree.leaves(rp)):
        b = np.asarray(b)
        if a.dtype == torch.bfloat16:
            assert _bf16_ulps(a, b) <= 1
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=0)


@pytest.mark.parametrize("warmup,total", [(10, 200), (2000, 100_000)])
def test_schedules_match_the_reference(warmup, total):
    steps = sorted(set(range(0, total + 20, max(1, total // 400)))
                   | {0, 1, warmup - 1, warmup, warmup + 1, total})
    for s in steps:
        c_ref = float(ref_cosine(s, peak_lr=3e-4, warmup=warmup, total=total))
        c = float(cosine(s, peak_lr=3e-4, warmup=warmup, total=total))
        assert abs(c - c_ref) <= 1e-7 * 3e-4, (s, c, c_ref)
        kw = dict(peak_lr=3e-4, warmup=warmup, stable=int(total * 0.8),
                  decay=int(total * 0.1))
        w_ref, w = float(ref_wsd(s, **kw)), float(wsd(s, **kw))
        assert abs(w - w_ref) <= 1e-7 * 3e-4, (s, w, w_ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_the_reference(arch):
    """make_train_step at step 3 of a 4-step warmup (lr 3/4 of peak): the
    metrics, the optimizer state and the updated params."""
    rcfg, cfg = configs(arch)
    lr = 1e-3
    rb, pb = batches(arch)
    rp = ref_params(arch)
    ref_step = jax.jit(ref_make_train_step(rcfg, peak_lr=lr, warmup=4,
                                           total=100))
    rp2, ropt, rm = ref_step(rp, ref_adamw_init(rp), rb, jnp.int32(3))
    pp = to_torch(rp)
    p0 = [to_numpy_f32(t) for t in tree_flatten(pp)]
    pp2, popt, pm = make_train_step(cfg, peak_lr=lr, warmup=4, total=100)(
        pp, adamw_init(pp), pb, 3)
    assert set(pm) == {"loss", "lr", "ce", "aux", "tokens", "grad_norm"}
    assert float(pm["lr"]) == float(rm["lr"]) == float(np.float32(0.75 * lr))
    for k in ("loss", "ce"):
        assert abs(float(pm[k]) - float(rm[k])) <= 1e-4 * abs(float(rm[k]))
    assert float(pm["tokens"]) == float(rm["tokens"])
    gn, gn_r = float(pm["grad_norm"]), float(rm["grad_norm"])
    assert abs(gn - gn_r) <= GRAD_TOL * gn_r, (gn, gn_r)
    assert int(popt.step) == 1
    for a, b in zip(tree_flatten(popt.mu), jax.tree.leaves(ropt.mu)):
        b = np.asarray(b)
        assert np.linalg.norm(a.numpy() - b) <= GRAD_TOL * max(
            np.linalg.norm(b), 1e-30)
    # the first Adam step moves each element by about lr (its sign may
    # flip where the two gradients are near zero): within 2 lr + 1 ulp
    for a, b in zip(tree_flatten(pp2), jax.tree.leaves(rp2)):
        a, b = to_numpy_f32(a), np.asarray(b.astype(jnp.float32))
        ulp = np.abs(b) * 2.0 ** -7
        assert np.all(np.abs(a - b) <= 2 * 0.75 * lr + ulp)
    # the update itself: where both first moments have one sign and the
    # reference's |mu| > 1e-6 (|g| > 1e-5, a thousand times AdamW's eps,
    # so the first step's g / (|g| + eps) is +-1 to 0.1%), p2 - p equals
    # the reference's rp2 - rp within a bf16 ulp of p plus 1e-3 lr; that
    # holds the sign of every such element, and covers most of them
    held = total = 0
    for a0, a, b0, b, m, rm_ in zip(p0, tree_flatten(pp2),
                                    jax.tree.leaves(rp), jax.tree.leaves(rp2),
                                    tree_flatten(popt.mu),
                                    jax.tree.leaves(ropt.mu)):
        d = to_numpy_f32(a) - a0
        rd = (np.asarray(b.astype(jnp.float32))
              - np.asarray(b0.astype(jnp.float32)))
        rm_ = np.asarray(rm_)
        sure = (np.sign(m.numpy()) == np.sign(rm_)) & (np.abs(rm_) > 1e-6)
        tol = np.abs(a0) * 2.0 ** -7 + 1e-3 * lr
        assert np.all(np.abs(d - rd)[sure] <= tol[sure])
        held += int(sure.sum())
        total += d.size
    assert held >= 0.95 * total, (held, total)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_steps_do_not_raise_the_loss(arch):
    """tests/test_nn_smoke.py's check on the port: two AdamW steps at lr
    3e-3 on one batch leave the loss no higher than 0.05 above it."""
    _, cfg = configs(arch)
    params = to_torch(ref_params(arch))
    batch = batches(arch)[1]
    opt = adamw_init(params)
    with torch.no_grad():
        l0 = float(lm_loss(params, batch, cfg)[0])
    leaves = tree_flatten(params)
    for _ in range(2):
        for t in leaves:
            t.requires_grad_(True)
        grads = torch.autograd.grad(lm_loss(params, batch, cfg)[0], leaves)
        for t in leaves:
            t.requires_grad_(False)
        from repro_torch.tree import tree_unflatten
        params, opt, _ = adamw_update(params, tree_unflatten(params, grads),
                                      opt, 3e-3)
    with torch.no_grad():
        l1 = float(lm_loss(params, batch, cfg)[0])
    assert l1 < l0 + 0.05, (l0, l1)
    assert 0.2 * np.log(cfg.vocab) < l0 < 3.0 * np.log(cfg.vocab)
