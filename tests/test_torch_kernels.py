"""The port's kernel wrappers on the CPU, where they take the plain PyTorch
versions, held against the reference's jnp oracles (`ref.py`) on the same
numpy inputs, at the shapes and tolerances of `tests/test_kernels.py`:
3e-4 in f32, 2e-2 in bf16 (one bf16 ulp near 1 is 2**-7 ≈ 8e-3; the two
frameworks round the final cast and sum in different orders); delta_apply
and pulse_count are integer functions and must match exactly; crossbar_mvm
is held to the reference's rtol 1e-5, atol 1e-2.  The CUDA kernels
themselves are held against the same plain versions on the card by
`chip_smoke.py`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.crossbar_mvm.ref import crossbar_mvm_ref
from repro.kernels.delta_apply.ref import delta_apply_ref
from repro.kernels.flash_attention.ref import flash_attention_ref as _flash_ref
from repro.kernels.paged_attention.ref import paged_attention_ref
from repro.kernels.pulse_count.ref import pulse_count_ref
from repro.configs import ARCHS, get_config
from repro_torch.kernels import aligned16
from repro_torch.kernels.crossbar_mvm import ops as crossbar_ops
from repro_torch.kernels.crossbar_mvm.ops import MAX_K, crossbar_mvm
from repro_torch.kernels.delta_apply.ops import apply_delta
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.pulse_count.ops import pulse_count

flash_attention_ref = jax.jit(_flash_ref, static_argnames="causal")
paged_attention_ref = jax.jit(paged_attention_ref)
DTYPES = {"float32": (jnp.float32, torch.float32, 3e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _both(x: np.ndarray, jdt, tdt):
    """The same f32 numpy values in both frameworks, rounded to the dtype
    (both round to nearest even)."""
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s,d,causal", [(128, 32, True), (200, 64, False),
                                        (256, 16, True), (77, 128, True),
                                        (200, 256, True), (96, 8, True),
                                        (77, 24, False), (130, 80, True)])
def test_flash_plain_matches_ref(s, d, causal, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(s + d)
    B, H = 2, 3
    q, k, v = (rng.standard_normal((B, s, H, d)).astype(np.float32)
               for _ in range(3))
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, jdt, tdt) for x in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=causal)
    fold = lambda x: x.transpose(0, 2, 1, 3).reshape(B * H, s, d)  # noqa: E731
    want = flash_attention_ref(fold(jq), fold(jk), fold(jv), causal=causal)
    want = want.reshape(B, H, s, d).transpose(0, 2, 1, 3)
    assert got.dtype == tdt and got.shape == (B, s, H, d)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_plain_gqa_matches_ref_with_repeated_kv(dtype):
    """GQA-native: query head h reads KV head h // G — the same as the
    reference oracle over K/V repeated G times."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(3)
    B, S, H, Hkv, D = 2, 77, 8, 2, 32
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
            for _ in range(2))
    got = flash_attention(*(_both(x, jdt, tdt)[1] for x in (q, k, v)))
    rep = lambda x: np.repeat(x, H // Hkv, axis=2)  # noqa: E731
    fold = lambda x: jnp.asarray(  # noqa: E731
        x.transpose(0, 2, 1, 3).reshape(B * H, S, D), jdt)
    want = flash_attention_ref(fold(q), fold(rep(k)), fold(rep(v)))
    want = want.reshape(B, H, S, D).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,h,hkv,d,pool,page,t",
                         [(3, 4, 2, 32, 9, 4, 6),    # GQA, odd pool
                          (2, 6, 6, 16, 5, 8, 4),    # MHA
                          (1, 8, 2, 64, 12, 16, 8),  # single row, big page
                          (2, 32, 2, 32, 9, 4, 4),   # G 16
                          (2, 10, 2, 16, 9, 4, 4),   # G 5
                          (3, 14, 2, 32, 12, 4, 4),  # G 7
                          (2, 8, 2, 8, 7, 4, 3),     # D 8
                          (2, 4, 4, 24, 7, 8, 3),    # D 24
                          (2, 4, 2, 80, 9, 4, 4)])   # D 80
def test_paged_plain_matches_ref(b, h, hkv, d, pool, page, t, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(b * pool + page)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((pool, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((pool, page, hkv, d)).astype(np.float32)
    tables = np.stack([rng.choice(pool, t, replace=False)
                       for _ in range(b)]).astype(np.int32)
    pos = rng.integers(0, t * page, b).astype(np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, jdt, tdt) for x in (q, kp, vp))
    got = paged_attention(tq, tk, tv, torch.from_numpy(tables),
                          torch.from_numpy(pos))
    want = paged_attention_ref(jq, jk, jv, jnp.asarray(tables),
                               jnp.asarray(pos))
    assert got.dtype == tdt and got.shape == (b, h, d)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_paged_plain_masks_stale_pages_bit_for_bit():
    """Pages past a row's position may hold arbitrary stale garbage without
    perturbing the output by a single bit."""
    rng = np.random.default_rng(7)
    b, h, hkv, d, pool, page, t = 2, 4, 2, 16, 10, 4, 5
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
    kp = rng.standard_normal((pool, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((pool, page, hkv, d)).astype(np.float32)
    tables = rng.permutation(pool).reshape(b, t).astype(np.int32)
    pos = np.asarray([5, 9], np.int32)
    args = (torch.from_numpy(tables), torch.from_numpy(pos))
    base = paged_attention(q, torch.from_numpy(kp.copy()),
                           torch.from_numpy(vp.copy()), *args)
    for row in range(b):
        for blk in range(pos[row] // page + 1, t):
            kp[tables[row, blk]] = 1e4 * rng.standard_normal((page, hkv, d))
            vp[tables[row, blk]] = 1e4
    out = paged_attention(q, torch.from_numpy(kp), torch.from_numpy(vp),
                          *args)
    np.testing.assert_array_equal(base.numpy(), out.numpy())
    want = paged_attention_ref(jnp.asarray(q.numpy()), jnp.asarray(kp),
                               jnp.asarray(vp), jnp.asarray(tables),
                               jnp.asarray(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-4)


def _paged_inputs(H=4, Hkv=2, D=8, P=6, T=3, B=2, page=4):
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32))
    kp = torch.from_numpy(rng.normal(size=(P, page, Hkv, D)).astype(np.float32))
    tables = torch.from_numpy(rng.integers(0, P, (B, T)).astype(np.int32))
    pos = torch.tensor([3, 5], dtype=torch.int32)
    return q, kp, kp.clone(), tables, pos


def test_paged_wrapper_rejects_non_divisible_heads():
    with pytest.raises(ValueError, match="not divisible"):
        paged_attention(*_paged_inputs(H=5, Hkv=2))


def test_paged_wrapper_rejects_non_int32_tables():
    q, kp, vp, tables, pos = _paged_inputs()
    for bad in (tables.float(), tables.long()):
        with pytest.raises(ValueError, match="int32"):
            paged_attention(q, kp, vp, bad, pos)


def _gqa_decode_shapes():
    """(head_dim, query heads per KV head) of every GQA config of the
    reference, smoke and full (MLA's decode never reaches this kernel)."""
    shapes = set()
    for arch in ARCHS:
        for smoke in (False, True):
            cfg = get_config(arch, smoke=smoke)
            if cfg.attn_type == "gqa":
                shapes.add((cfg.head_dim, cfg.n_heads // cfg.n_kv_heads))
    return sorted(shapes)


def test_paged_kernel_contract_takes_every_reference_gqa_config():
    """The kernel's contract, checked in pure Python before any launch:
    every head dim and group size of the reference's GQA configs passes,
    and the others raise.  (The split plan lives in the kernel's library;
    `chip_smoke.py` holds its invariants on the card.)"""
    shapes = _gqa_decode_shapes()
    assert {(8, 4), (16, 2), (128, 16), (64, 5), (128, 7)} <= set(shapes)
    for head_dim, group in shapes:
        paged_ops.check_contract(head_dim, group)
    for head_dim, group in ((12, 1), (128, 17), (264, 1), (0, 1), (64, 0)):
        with pytest.raises(ValueError):
            paged_ops.check_contract(head_dim, group)


@pytest.mark.parametrize("d,width", [(8, 32), (16, 32), (24, 32), (32, 32),
                                     (80, 128), (128, 128), (192, 256),
                                     (256, 256)])
def test_flash_head_dim_padding_is_exact(d, width):
    """Off the kernel's four native widths the wrapper zero-pads q, k and v
    along D and passes the true 1/sqrt(D): through the plain version, the
    padded inputs with that scale give the unpadded result."""
    assert flash_ops.native_head_dim(d) == width
    rng = np.random.default_rng(d)
    B, S, H, Hkv = 2, 37, 4, 2
    q = torch.from_numpy(rng.standard_normal((B, S, H, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, Hkv, d))
                             .astype(np.float32)) for _ in range(2))
    want = flash_attention_plain(q, k, v, causal=True)
    padded = [flash_ops.pad_head_dim(x, width) for x in (q, k, v)]
    assert all(x.shape[-1] == width for x in padded)
    got = flash_attention_plain(*padded, causal=True,
                                scale=1.0 / np.sqrt(d))[..., :d]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("ops", [paged_ops, flash_ops],
                         ids=["paged", "flash"])
def test_kernel_wrappers_take_bf16_and_f32(ops):
    """Each attention wrapper takes what its Pallas kernel takes: bf16 goes
    to the bf16 kernel, f32 to the f32 kernel (paged: full f32 FMAs;
    flash: split TF32, three tensor-core products per fragment, since one
    TF32 pass would not hold 3e-4); any other dtype, or a mix, raises
    before a launch."""
    name = ops.__name__.split(".")[-2]
    x = torch.zeros(2, 4, 8)
    b = x.bfloat16()
    assert ops.kernel_for(b, b, b) == name
    assert ops.kernel_for(x, x, x) == f"{name}_f32"
    for bad in ((x.half(), x.half(), x.half()), (x, b, b), (b, b, x),
                (x.double(), x, x)):
        with pytest.raises(ValueError, match="bf16 or f32"):
            ops.kernel_for(*bad)


def _tf32(x: np.ndarray, rounded: bool = True) -> np.ndarray:
    """f32 `x` in TF32: rounded to nearest, ties away from zero, as
    cvt.rna.tf32.f32 rounds (add 0x1000 to the bit pattern, clear the low
    13 bits), or, with rounded False, cut to its top 19 bits, as the
    tensor core reads an f32 register."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    if rounded:
        bits = bits + np.uint32(0x1000)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_product(a: np.ndarray, b: np.ndarray, passes: int) -> np.ndarray:
    """a @ b as the f32 flash kernel takes it (passes 3: hi = x rounded to
    TF32, lo = x - hi as the tensor core reads it, a_lo·b_hi + a_hi·b_lo +
    a_hi·b_hi), or in one TF32 pass (passes 1); exact products, f32
    result."""
    f64 = lambda x: x.astype(np.float64)  # noqa: E731
    ah, bh = _tf32(a), _tf32(b)
    out = f64(ah) @ f64(bh)
    if passes == 3:
        al, bl = _tf32(a - ah, rounded=False), _tf32(b - bh, rounded=False)
        out = f64(al) @ f64(bh) + f64(ah) @ f64(bl) + out
    return out.astype(np.float32)


@pytest.mark.parametrize("passes", [3, 1], ids=["3xtf32", "1xtf32"])
@pytest.mark.parametrize("s,d,h,hkv", [(64, 32, 2, 2), (96, 80, 4, 2),
                                       (48, 128, 3, 1)])
def test_flash_f32_kernel_needs_split_tf32(s, d, h, hkv, passes):
    """Causal f32 attention with both products (Q·Kᵀ, P·V) taken as the
    f32 flash kernel takes them, against `flash_attention_plain` in full
    f32: three split-TF32 passes stay within 3e-5 (the limit
    `chip_smoke.py` holds the kernel to); one TF32 pass misses the
    reference's 3e-4.  That is why the kernel splits."""
    rng = np.random.default_rng(s + d)
    q = rng.standard_normal((1, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, s, hkv, d)).astype(np.float32)
            for _ in range(2))
    want = flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal=True).numpy()
    got = np.empty_like(want)
    causal = np.tril(np.ones((s, s), bool))
    for head in range(h):
        kv = head // (h // hkv)
        scores = _tf32_product(q[0, :, head], k[0, :, kv].T, passes)
        scores = np.where(causal, scores / np.float32(np.sqrt(d)), -1e30)
        p = np.exp(scores - scores.max(-1, keepdims=True))
        p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
        got[0, :, head] = _tf32_product(p, v[0, :, kv], passes)
    err = np.abs(got - want).max()
    if passes == 3:
        assert err <= 3e-5
    else:
        assert err > 3e-4


def test_f32_kernel_sources_sit_beside_their_bf16_kernels():
    """The build finds each f32 library's source in its kernel package."""
    from repro_torch.kernels import build
    for name in ("paged_attention", "flash_attention"):
        assert name in build.NAMES and f"{name}_f32" in build.NAMES
        assert build.source(f"{name}_f32").is_file()
        assert build.source(f"{name}_f32").parent == build.source(name).parent


def test_flash_kernel_contract_rejects_other_head_dims():
    for d in (12, 4, 264):
        with pytest.raises(ValueError, match="multiple of 8"):
            flash_ops.native_head_dim(d)


def test_flash_wrapper_rejects_non_divisible_heads():
    q = torch.zeros(1, 8, 5, 16)
    kv = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="not divisible"):
        flash_attention(q, kv, kv)


def _misaligned(shape, dtype):
    """A contiguous view whose data starts 1 element past an aligned
    allocation."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


def test_flash_aligned16_copies_only_misaligned_inputs():
    """The kernel's TMA copies read from 16-byte aligned addresses only:
    an input whose data does not start on such a boundary is copied, an
    aligned one is not."""
    x = torch.randn(1, 8, 2, 16).bfloat16()
    assert x.data_ptr() % 16 == 0 and aligned16(x) is x
    y = _misaligned((1, 8, 2, 16), torch.bfloat16)
    y.copy_(x)
    assert y.data_ptr() % 16 != 0 and y.is_contiguous()
    z = aligned16(y)
    assert z is not y and z.data_ptr() % 16 == 0 and torch.equal(z, x)


def test_launch_counters_stay_zero_on_cpu():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    p0, f0 = paged_attention.launches, flash_attention.launches
    paged_attention(*_paged_inputs())
    x = torch.zeros(1, 8, 2, 16)
    flash_attention(x, x, x)
    assert (paged_attention.launches, flash_attention.launches) == (p0, f0)
    assert p0 == f0 == 0


# ------------------------------------------- the ARAS install kernels
@pytest.mark.parametrize("n", [17, 4096, 70_001])
def test_delta_apply_plain_matches_ref(n):
    rng = np.random.default_rng(n)
    old = rng.integers(0, 256, n, dtype=np.uint8)
    new = rng.integers(0, 256, n, dtype=np.uint8)
    delta = ((new.astype(np.int32) - old.astype(np.int32)) % 256
             ).astype(np.uint8)
    got = apply_delta(torch.from_numpy(old), torch.from_numpy(delta))
    want = np.asarray(delta_apply_ref(jnp.asarray(old), jnp.asarray(delta)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), new)
    # in place into the old codes, as an install writes its slot
    slot = torch.from_numpy(old.copy())
    assert apply_delta(slot, torch.from_numpy(delta), out=slot) is slot
    np.testing.assert_array_equal(slot.numpy(), new)


@pytest.mark.parametrize("n", [100, 33_000])
def test_pulse_count_plain_matches_ref(n):
    rng = np.random.default_rng(n)
    old = rng.integers(0, 256, n, dtype=np.uint8)
    new = rng.integers(0, 256, n, dtype=np.uint8)
    p, s = pulse_count(torch.from_numpy(old), torch.from_numpy(new))
    pr, sr = pulse_count_ref(jnp.asarray(old), jnp.asarray(new))
    assert p.dtype == s.dtype == torch.int64
    assert (int(p), int(s)) == (int(pr), int(sr))


@pytest.mark.parametrize("m,k,n", [(8, 64, 8), (70, 300, 90), (128, 128, 128),
                                   (200, 1000, 64), (8, 3071, 200)])
def test_crossbar_mvm_plain_matches_ref(m, k, n):
    rng = np.random.default_rng(m * k + n)
    x = rng.integers(0, 256, (m, k), dtype=np.uint8)
    w = rng.integers(0, 256, (k, n), dtype=np.uint8)
    zx = np.float32(rng.uniform(0, 255))
    zw = np.float32(rng.uniform(0, 255))
    sc = np.float32(10 ** rng.uniform(-5, -2))
    got = crossbar_mvm(torch.from_numpy(x), torch.from_numpy(w), zx, zw, sc)
    want = crossbar_mvm_ref(jnp.asarray(x), jnp.asarray(w), jnp.float32(zx),
                            jnp.float32(zw), jnp.float32(sc))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-2)


@pytest.mark.parametrize("k,kp", [(1, 16), (16, 16), (300, 304),
                                  (3071, 3072), (3072, 3072),
                                  (MAX_K, 33040)])
def test_crossbar_padded_k(k, kp):
    """The K-major operands' row pitch: K rounded up to 16 bytes."""
    assert crossbar_ops.padded_k(k) == kp


def test_crossbar_scratch_contract():
    """The kernel reads the weights transposed (N, Kp) and the activations
    in place only when TMA can (rows 16 bytes apart, data 16-byte aligned);
    otherwise from a zero-padded (M, Kp) copy its prep pass writes."""
    w = torch.zeros(3072, 40, dtype=torch.uint8)
    x = torch.zeros(8, 3072, dtype=torch.uint8)
    assert crossbar_ops.tma_ready(x)
    wt, sums, xp = crossbar_ops.scratch(x, w)
    assert (wt.dtype, tuple(wt.shape)) == (torch.uint8, (40, 3072))
    assert (sums.dtype, tuple(sums.shape)) == (torch.int32, (8 + 40,))
    assert xp is None and wt.device == sums.device == x.device
    for ragged in (torch.zeros(8, 3071, dtype=torch.uint8),
                   _misaligned((8, 3072), torch.uint8)):
        assert not crossbar_ops.tma_ready(ragged)
        wt, sums, xp = crossbar_ops.scratch(
            ragged, torch.zeros(ragged.shape[1], 40, dtype=torch.uint8))
        kp = crossbar_ops.padded_k(ragged.shape[1])
        assert tuple(wt.shape) == (40, kp)
        assert (xp.dtype, tuple(xp.shape)) == (torch.uint8, (8, kp))


def test_launch_error_names_the_failing_layer():
    """A kernel's return code: a cudaError_t, or 100000 + the CUresult of a
    TMA tensor map CUDA refused to encode."""
    from repro_torch.kernels.build import launch_error
    assert launch_error(1) == "cudaError 1"
    assert launch_error(100001) == "tensor map refused, CUresult 1"


def test_install_kernel_wrappers_reject_bad_inputs():
    u8 = torch.zeros(8, dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint8"):
        apply_delta(u8, u8.to(torch.int32))
    with pytest.raises(ValueError, match="one shape"):
        pulse_count(u8, torch.zeros(9, dtype=torch.uint8))
    with pytest.raises(ValueError, match="overflow"):
        crossbar_mvm(torch.zeros(1, MAX_K + 1, dtype=torch.uint8),
                     torch.zeros(MAX_K + 1, 1, dtype=torch.uint8), 0., 0., 1.)
    with pytest.raises(ValueError, match=r"\(M, K\)"):
        crossbar_mvm(torch.zeros(2, 3, dtype=torch.uint8),
                     torch.zeros(4, 2, dtype=torch.uint8), 0., 0., 1.)


def test_install_kernel_launch_counters_stay_zero_on_cpu():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    a = torch.arange(64, dtype=torch.uint8)
    apply_delta(a, a)
    pulse_count(a, a)
    crossbar_mvm(a.view(8, 8), a.view(8, 8), 1., 2., 0.5)
    assert apply_delta.launches == pulse_count.launches == \
        crossbar_mvm.launches == 0
