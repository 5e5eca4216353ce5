"""Shared set-up of the port's training parity tests
(`tests/test_torch_train*.py`): the reference trainer's params
(`init_params(PRNGKey(0))`, every float leaf of two or more dims cast to
bf16 as `repro.launch.train` casts them) carried into the port leaf for
leaf in the same dtypes, one `make_batch` batch in both frameworks, and
the loss and its gradient in each package."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.data.pipeline import DataConfig
from repro.data.pipeline import make_batch as ref_make_batch
from repro.nn.model import init_params as ref_init_params
from repro.nn.model import lm_loss as ref_lm_loss
from repro_torch.configs import get_config
from repro_torch.nn.model import lm_loss
from repro_torch.tree import tree_flatten

B, S = 2, 16
_PARAMS = {}
_REF = {}


def configs(arch):
    """(reference, port) smoke configs; "name@L" cuts or grows the stack
    to L layers (4 or more make a stacked, scanned segment)."""
    name, _, layers = arch.partition("@")
    pair = ref_config(name, smoke=True), get_config(name, smoke=True)
    if layers:
        pair = tuple(dataclasses.replace(c, n_layers=int(layers))
                     for c in pair)
    return pair


def ref_params(arch):
    """The reference trainer's params for `arch` at smoke (cached)."""
    if arch not in _PARAMS:
        p = ref_init_params(jax.random.PRNGKey(0), configs(arch)[0])
        _PARAMS[arch] = jax.tree.map(
            lambda a: a.astype(jnp.bfloat16)
            if jnp.issubdtype(a.dtype, jnp.floating) and a.ndim >= 2 else a,
            p)
    return _PARAMS[arch]


def to_torch(tree):
    """Numpy/jax leaves -> torch tensors of the same dtype (bf16 through
    its uint16 bits), containers kept."""
    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree.map(leaf, tree)


def to_numpy_f32(t):
    return t.detach().float().numpy()


def batches(arch, step=0):
    """(reference batch, port batch) of make_batch(step) at B x S."""
    rcfg, _ = configs(arch)
    nb = ref_make_batch(rcfg, DataConfig(seq_len=S, global_batch=B), step)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def ref_loss_and_grads(arch, step=0):
    """(loss, metrics, grads) of the reference's jitted value_and_grad."""
    key = (arch, step)
    if key not in _REF:
        rcfg, _ = configs(arch)
        fn = jax.jit(jax.value_and_grad(
            lambda p, b: ref_lm_loss(p, b, rcfg), has_aux=True))
        (loss, metrics), grads = fn(ref_params(arch), batches(arch, step)[0])
        _REF[key] = (float(loss), jax.tree.map(float, metrics), grads)
    return _REF[key]


def port_loss_and_grads(arch, params, step=0):
    """(loss, metrics, grads in tree_flatten order) of the port's lm_loss
    by autograd."""
    _, cfg = configs(arch)
    leaves = tree_flatten(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = lm_loss(params, batches(arch, step)[1], cfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for t in leaves:
        t.requires_grad_(False)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in metrics.items()}, grads)


def grad_rel_errors(arch, params):
    """Each leaf's ||g_port - g_ref|| / ||g_ref|| (f32), the two losses and
    metrics, and the gradient dtypes of both."""
    loss_r, met_r, grads_r = ref_loss_and_grads(arch)
    loss_p, met_p, grads_p = port_loss_and_grads(arch, params)
    flat_r = jax.tree.leaves(grads_r)
    assert len(flat_r) == len(grads_p)
    errs = []
    for gr, gp in zip(flat_r, grads_p):
        assert str(gp.dtype).endswith(str(gr.dtype)), (gp.dtype, gr.dtype)
        gr = np.asarray(gr.astype(jnp.float32))
        gp = to_numpy_f32(gp)
        errs.append(float(np.linalg.norm(gp - gr)
                          / max(np.linalg.norm(gr), 1e-30)))
    return errs, (loss_p, met_p), (loss_r, met_r)
