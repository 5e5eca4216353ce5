"""The port's flash attention Function (`repro_torch.nn.flash`) against the
reference's `repro.nn.flash.flash_chunked` and its custom VJP, on the same
numpy inputs in f32: o, lse, dq, dk and dv to 3e-4 (the reference kernel
tests' f32 tolerance).  On the CPU the forward takes the kernel's plain
version; the backward is the reference's `_vjp_bwd` in torch ops.  The
reference's layout is (B, Hkv, G, S, D); the port's is the kernel's,
q (B, S, H, D) and k/v (B, S, Hkv, D), and `_to_port` / `_to_ref` adapt."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn.flash import _attend_fwd, _vjp_bwd, flash_chunked
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.nn import attention as attn_mod
from repro_torch.nn import flash as flash_mod
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.nn.flash import flash_attention_train, flash_backward

TOL = 3e-4
Q_CHUNK, KV_CHUNK = 16, 32

# (B, S, Hkv, G, D, causal): G 1 and G > 1, S not a multiple of the
# q chunk (nor of the kv chunk), full attention, and D 80 (an off-native
# width the card's kernel zero-pads to 128)
CASES = [(2, 48, 2, 1, 32, True), (1, 40, 2, 3, 32, True),
         (2, 37, 1, 2, 16, False), (1, 53, 2, 2, 80, True),
         (2, 29, 3, 1, 64, False), (1, 70, 1, 4, 24, True)]
IDS = [f"B{b}-S{s}-Hkv{h}-G{g}-D{d}-{'causal' if c else 'full'}"
       for b, s, h, g, d, c in CASES]


def _draws(B, S, Hkv, G, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hkv, G, S, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    do = rng.standard_normal((B, Hkv, G, S, D)).astype(np.float32)
    return q, k, v, do


def _to_port(q, k, v, do):
    """Reference layout (numpy) -> the kernel's layout (torch)."""
    B, Hkv, G, S, D = q.shape
    qt = torch.from_numpy(q).permute(0, 3, 1, 2, 4).reshape(B, S, Hkv * G, D)
    dot = torch.from_numpy(do).permute(0, 3, 1, 2, 4).reshape(B, S, Hkv * G,
                                                              D)
    kt = torch.from_numpy(k).permute(0, 2, 1, 3)
    vt = torch.from_numpy(v).permute(0, 2, 1, 3)
    return qt.contiguous(), kt.contiguous(), vt.contiguous(), dot.contiguous()


def _q_to_ref(x, Hkv):
    """(B, S, H, D) torch -> (B, Hkv, G, S, D) numpy."""
    B, S, H, D = x.shape
    return x.detach().reshape(B, S, Hkv, H // Hkv, D).permute(
        0, 2, 3, 1, 4).numpy()


def _kv_to_ref(x):
    return x.detach().permute(0, 2, 1, 3).numpy()


def _reference(q, k, v, do, causal):
    fn = lambda q, k, v: flash_chunked(q, k, v, causal, 0, Q_CHUNK, KV_CHUNK)
    o, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    dq, dk, dv = vjp(jnp.asarray(do))
    _, lse = _attend_fwd(*(jnp.asarray(x) for x in (q, k, v)), causal, 0,
                         Q_CHUNK, KV_CHUNK)
    return [np.asarray(x) for x in (o, lse, dq, dk, dv)]


def _close(got, want, what):
    err = np.max(np.abs(got - want))
    assert err <= TOL * max(1.0, np.max(np.abs(want))), (what, err)


@pytest.mark.parametrize("B,S,Hkv,G,D,causal", CASES, ids=IDS)
def test_function_matches_flash_chunked_vjp(B, S, Hkv, G, D, causal):
    q, k, v, do = _draws(B, S, Hkv, G, D, seed=S * D + G)
    o_r, lse_r, dq_r, dk_r, dv_r = _reference(q, k, v, do, causal)
    qt, kt, vt, dot = _to_port(q, k, v, do)
    qt, kt, vt = (t.requires_grad_(True) for t in (qt, kt, vt))
    o = flash_attention_train(qt, kt, vt, causal, Q_CHUNK, KV_CHUNK)
    o.backward(dot)
    _close(_q_to_ref(o, Hkv), o_r, "o")
    _close(_q_to_ref(qt.grad, Hkv), dq_r, "dq")
    _close(_kv_to_ref(kt.grad), dk_r, "dk")
    _close(_kv_to_ref(vt.grad), dv_r, "dv")
    # the forward's lse, (B, H, S) -> (B, Hkv, G, S)
    _, lse = flash_attention(qt.detach(), kt.detach(), vt.detach(), causal,
                             return_lse=True)
    _close(lse.reshape(B, Hkv, G, S).numpy(), lse_r, "lse")


@pytest.mark.parametrize("B,S,Hkv,G,D,causal", CASES[:3], ids=IDS[:3])
def test_plain_lse_matches_attend_fwd(B, S, Hkv, G, D, causal):
    """The kernel's plain version with return_lse against the reference
    forward's lse and o, at the reference's default chunks."""
    q, k, v, do = _draws(B, S, Hkv, G, D, seed=7 + S)
    o_r, lse_r = (np.asarray(x) for x in _attend_fwd(
        *(jnp.asarray(x) for x in (q, k, v)), causal, 0, 512, 1024))
    qt, kt, vt, _ = _to_port(q, k, v, do)
    o, lse = flash_attention_plain(qt, kt, vt, causal, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, Hkv * G, S)
    _close(lse.reshape(B, Hkv, G, S).numpy(), lse_r, "lse")
    _close(_q_to_ref(o, Hkv), o_r, "o")


@pytest.mark.parametrize("causal", [True, False])
def test_backward_alone_matches_vjp_bwd(causal):
    """`flash_backward` against `_vjp_bwd` fed the same residuals (the
    reference's o and lse), at the reference's own default chunks and at
    blocks smaller than the sequence."""
    B, S, Hkv, G, D = 1, 45, 2, 2, 32
    q, k, v, do = _draws(B, S, Hkv, G, D, seed=99)
    for qc, kc in ((512, 1024), (8, 16)):
        o_r, lse_r = _attend_fwd(*(jnp.asarray(x) for x in (q, k, v)),
                                 causal, 0, qc, kc)
        want = _vjp_bwd(causal, 0, qc, kc,
                        (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         o_r, lse_r), jnp.asarray(do))
        qt, kt, vt, dot = _to_port(q, k, v, do)
        ot = torch.from_numpy(np.array(o_r)).permute(0, 3, 1, 2, 4).reshape(
            B, S, Hkv * G, D)
        lset = torch.from_numpy(np.array(lse_r)).reshape(B, Hkv * G, S)
        dq, dk, dv = flash_backward(qt, kt, vt, ot, lset, dot, causal, qc, kc)
        _close(_q_to_ref(dq, Hkv), np.asarray(want[0]), "dq")
        _close(_kv_to_ref(dk), np.asarray(want[1]), "dk")
        _close(_kv_to_ref(dv), np.asarray(want[2]), "dv")


def test_bf16_function_keeps_dtypes_and_matches_plain_autograd():
    """bf16 inputs: o and the gradients come back bf16, within the bf16
    tolerance (2e-2) of autograd through the plain version."""
    rng = np.random.default_rng(5)
    B, S, H, Hkv, D = 2, 33, 4, 2, 32
    q, do = (torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, Hkv, D)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    a = [t.clone().requires_grad_(True) for t in (q, k, v)]
    b = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_attention_train(*a, True).backward(do)
    flash_attention_plain(*b, True).backward(do)
    for x, y in zip(a, b):
        assert x.grad.dtype == torch.bfloat16
        err = (x.grad.float() - y.grad.float()).abs().max().item()
        assert err <= 2e-2 * max(1.0, y.grad.float().abs().max().item()), err


def test_mla_padded_v_gradient_reaches_only_true_columns():
    """MLA's prefill pads V to K's width before the call and slices the
    output back (`nn/attention.py`): the gradient of the true V columns
    equals autograd through the unpadded plain attention, and nothing of
    the padding survives."""
    rng = np.random.default_rng(11)
    B, S, H, Dk, Dv = 1, 24, 2, 48, 32
    q, k = (torch.from_numpy(rng.standard_normal((B, S, H, Dk)).astype(
        np.float32)) for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((B, S, H, Dv)).astype(
        np.float32))
    do = torch.from_numpy(rng.standard_normal((B, S, H, Dv)).astype(
        np.float32))
    a = [t.clone().requires_grad_(True) for t in (q, k, v)]
    vp = torch.nn.functional.pad(a[2], (0, Dk - Dv))
    flash_attention_train(a[0], a[1], vp, True)[..., :Dv].backward(do)
    b = [t.clone().requires_grad_(True) for t in (q, k, v)]
    qg = b[0].float()
    s = torch.einsum("bqhd,bkhd->bhqk", qg, b[1]) / np.sqrt(Dk)
    s = torch.where(torch.ones(S, S, dtype=torch.bool).tril(), s,
                    torch.full_like(s, -1e30))
    torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), b[2]).backward(do)
    assert a[2].grad.shape == (B, S, H, Dv)
    for x, y in zip(a, b):
        err = (x.grad - y.grad).abs().max().item()
        assert err <= TOL * max(1.0, y.grad.abs().max().item()), err


def test_attention_routes_the_function_only_under_autograd(monkeypatch):
    """`nn.attention._flash`: recording autograd goes through the
    Function, serving (no grad, or inputs that need none) through the
    kernel's wrapper alone."""
    calls = []
    monkeypatch.setattr(attn_mod, "flash_attention_train",
                        lambda *a: calls.append("train") or
                        flash_attention_train(*a))
    monkeypatch.setattr(attn_mod, "flash_attention",
                        lambda q, k, v, causal: calls.append("serve") or
                        flash_attention_plain(q, k, v, causal))
    q = torch.randn(1, 8, 2, 16, generator=torch.Generator().manual_seed(0))
    k = v = q[:, :, :1].contiguous()
    attn_mod._flash(q, k, v, True)
    with torch.no_grad():
        attn_mod._flash(q.requires_grad_(True), k, v, True)
    attn_mod._flash(q, k, v, True).sum().backward()
    assert calls == ["serve", "serve", "train"]
    assert flash_mod.FlashAttention is not None
