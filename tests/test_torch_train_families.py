"""The training loss and its gradient on the other eight families of the
registry at smoke, against the reference on the reference trainer's own
params: the MoE router's aux loss (qwen3-moe, deepseek-v2-lite with MLA),
the hybrid attention ∥ Mamba block (hymba), mLSTM and sLSTM (xlstm), the
encoder's targets and loss mask (hubert), the prefix VLM's text-only loss
(paligemma) and the dense GQA decoders.  `lm_loss` within 1e-4 relative,
aux within 1e-5 relative, every gradient leaf within 3e-2 in relative
norm, in the reference's dtype.  Then the recurrent cells' training route
(out-of-place Mamba steps, each chunk of steps rematerialized) gives the
serving route's forward values bit for bit, and its gradient equals the
one taken without remat."""
import numpy as np
import pytest
import torch

from repro_torch.nn import ssm
from repro_torch.configs import get_config

from train_pair import configs, grad_rel_errors, ref_params, to_torch

ARCHS = ["yi-34b", "qwen3-32b", "qwen3-moe-235b-a22b", "deepseek-v2-lite-16b",
         "hymba-1.5b", "xlstm-350m", "hubert-xlarge", "paligemma-3b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf(arch):
    rcfg, _ = configs(arch)
    params = to_torch(ref_params(arch))
    errs, (loss_p, met_p), (loss_r, met_r) = grad_rel_errors(arch, params)
    assert abs(loss_p - loss_r) <= 1e-4 * abs(loss_r), (loss_p, loss_r)
    assert met_p["tokens"] == met_r["tokens"]
    assert abs(met_p["aux"] - met_r["aux"]) <= 1e-5 * max(met_r["aux"], 1.0)
    if rcfg.n_experts:
        assert met_r["aux"] > 0
    assert max(errs) <= 3e-2, sorted(errs)[-5:]


def _cell_inputs(arch, S, seed):
    cfg = get_config(arch, smoke=True)
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(2, S, cfg.d_model, generator=g) * 0.5).to(torch.bfloat16)
    return cfg, x


def _mamba_params(cfg, seed):
    from repro_torch.nn.model import _init_mamba
    g = torch.Generator().manual_seed(seed)

    def normal(shape, scale, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g) * scale).to(dtype)

    return _init_mamba(cfg, normal,
                       lambda v, *shape: torch.full(shape, float(v)))


def _slstm_params(cfg, seed):
    from repro_torch.nn.model import _init_slstm
    g = torch.Generator().manual_seed(seed)

    def normal(shape, scale, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g) * scale).to(dtype)

    return _init_slstm(cfg, normal,
                       lambda v, *shape: torch.full(shape, float(v)))


CELLS = {"mamba": ("hymba-1.5b", ssm.mamba, _mamba_params),
         "slstm": ("xlstm-350m", ssm.slstm, _slstm_params)}


def _run(cell, params, x, cfg):
    leaves = [t for t in params.values() if torch.is_tensor(t)]
    leaves += [t for sub in params.values() if isinstance(sub, dict)
               for t in sub.values()]
    for t in leaves:
        t.requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    y, _ = cell(params, xr, cfg)
    (grad_x,) = torch.autograd.grad(y.float().square().sum(), [xr])
    for t in leaves:
        t.requires_grad_(False)
    return y.detach(), grad_x


@pytest.mark.parametrize("name", list(CELLS))
def test_recurrent_training_route_matches_serving_and_no_remat(name,
                                                               monkeypatch):
    """S 300 > CHUNK (two remat chunks).  The serving route (no grad) and
    the training route give equal outputs; the training route's gradient
    with each chunk rematerialized equals the gradient with the chunks
    run plainly."""
    arch, cell, make = CELLS[name]
    cfg, x = _cell_inputs(arch, 300, seed=3)
    params = make(cfg, seed=4)
    with torch.no_grad():
        y_serve, _ = cell(params, x, cfg)
    y_train, g_remat = _run(cell, params, x, cfg)
    assert torch.equal(y_train, y_serve)
    calls = []

    def plain(fn, *args, use_reentrant):
        calls.append(use_reentrant)
        return fn(*args)

    monkeypatch.setattr(ssm, "checkpoint", plain)
    y_plain, g_plain = _run(cell, params, x, cfg)
    assert calls == [False, False]          # two chunks of CHUNK steps
    assert torch.equal(y_plain, y_serve)
    assert torch.equal(g_remat, g_plain)
    assert torch.isfinite(g_remat).all() and g_remat.abs().sum() > 0


def test_mlstm_chunkwise_prefill_differentiates():
    """mLSTM's chunkwise form carries gradients as it is: a training-mode
    forward equals the serving forward, and its gradient is finite."""
    cfg, x = _cell_inputs("xlstm-350m", 300, seed=5)
    from repro_torch.nn.model import _init_mlstm
    g = torch.Generator().manual_seed(6)
    params = _init_mlstm(
        cfg, lambda shape, scale, dtype=torch.bfloat16:
        (torch.randn(shape, generator=g) * scale).to(dtype),
        lambda v, *shape: torch.full(shape, float(v)))
    with torch.no_grad():
        y_serve, _ = ssm.mlstm(params, x, cfg)
    y, gx = _run(ssm.mlstm, params, x, cfg)
    assert torch.equal(y, y_serve)
    assert torch.isfinite(gx).all() and np.abs(gx.float().numpy()).sum() > 0
