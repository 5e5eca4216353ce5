"""The port's sampler against jax's threefry stream: PRNG keys, `fold_in`,
the 32-bit draws and the uniforms that feed `jax.random.categorical` must
be bit for bit jax's (threefry2x32, partitionable — jax's default), and the
sampled tokens equal the reference's on the grid of
`tests/test_kernel_backend.py::test_fused_sampler_matches_host_grid`
(temperature x top-k x seed, padded vocab tail poisoned).  The Gumbel
floats themselves go through `log`, which may differ in the last ulp
between XLA and PyTorch, so tokens, not floats, are compared there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import sampling as ref
from repro_torch.serving import sampling

SEEDS = [0, 1, 7, 11, 12345, 2**31 - 1, -5, 2**32 + 3]
STEPS = [0, 1, 5, 1000, 2**31 - 1]
VOCAB = 512


def _jkey(seed):
    return np.asarray(jax.random.PRNGKey(seed), np.uint32)


def test_keys_and_fold_in_match_jax():
    for seed in SEEDS:
        key = sampling.prng_key(seed)
        np.testing.assert_array_equal(key, _jkey(seed))
        np.testing.assert_array_equal(sampling.request_key(None, seed),
                                      np.asarray(ref.request_key(None, seed)))
        np.testing.assert_array_equal(sampling.request_key(seed, 3),
                                      np.asarray(ref.request_key(seed, 3)))
        folded = sampling.fold_in(
            torch.as_tensor(np.tile(key.astype(np.int64), (len(STEPS), 1))),
            torch.tensor(STEPS))
        want = np.stack([np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                       s)) for s in STEPS])
        np.testing.assert_array_equal(folded.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n", [1, 37, 1001])
def test_random_bits_and_uniforms_match_jax(n):
    for seed in SEEDS[:3]:
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
        tkey = torch.as_tensor(np.asarray(key).astype(np.int64))
        bits = sampling.random_bits(tkey, n)
        np.testing.assert_array_equal(
            bits.numpy(), np.asarray(jax.random.bits(key, (n,), jnp.uint32)))
        tiny = np.finfo(np.float32).tiny
        want = np.asarray(jax.random.uniform(key, (n,), jnp.float32,
                                             minval=tiny, maxval=1.0))
        got = sampling.uniform_tiny(bits).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_sampled_tokens_match_reference_grid():
    """The reference's host grid: 6 rows x temperature x top-k x seed, the
    padded tail at +1e9 (it must be masked, not sampled); batched and
    per-row samplers both equal the reference's."""
    pad, B = 64, 6
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(B, VOCAB + pad)).astype(np.float32)
    logits[:, VOCAB:] = 1e9
    tl, jl = torch.from_numpy(logits), jnp.asarray(logits)
    for temp in (0.0, 0.7, 1.3):
        for tk in (0, 1, 5, VOCAB):
            for seed in (None, 7):
                keys = [sampling.request_key(seed, r) for r in range(B)]
                steps = [r * 3 for r in range(B)]
                want = np.asarray(ref.sample_tokens(
                    jl, VOCAB, temperatures=jnp.full((B,), temp, jnp.float32),
                    top_ks=jnp.full((B,), tk, jnp.int32),
                    keys=jnp.asarray(np.stack(keys)),
                    steps=jnp.asarray(steps, dtype=jnp.int32)))
                got = sampling.sample_tokens(
                    tl, VOCAB, temperatures=np.full(B, temp), top_ks=np.full(B, tk),
                    keys=keys, steps=steps)
                assert got.dtype == torch.int32
                assert got.tolist() == want.tolist(), (temp, tk, seed)
                rows = [sampling.sample_token(tl[r], VOCAB, temperature=temp,
                                              top_k=tk, key=keys[r],
                                              step=steps[r])
                        for r in range(B)]
                assert rows == want.tolist(), (temp, tk, seed)
                assert all(t < VOCAB for t in rows)


def test_sampled_tokens_match_reference_on_random_rows():
    """Many single draws on wide random logits: any disagreement in the
    stream would flip most of them."""
    rng = np.random.default_rng(2)
    for t in range(60):
        row = (rng.normal(size=VOCAB) * 3).astype(np.float32)
        temp, tk, seed = (0.7, 1.3, 0.9)[t % 3], (0, 1, 5, VOCAB, 7)[t % 5], \
            (None, 7, 11)[t % 3]
        want = ref.sample_token(jnp.asarray(row), VOCAB, temperature=temp,
                                top_k=tk, key=ref.request_key(seed, t),
                                step=t)
        got = sampling.sample_token(torch.from_numpy(row), VOCAB,
                                    temperature=temp, top_k=tk,
                                    key=sampling.request_key(seed, t), step=t)
        assert got == want, t


def test_mixed_rows_one_call():
    """Greedy, sampled and top-k rows in one batched call, each equal to
    the reference's per-row sampler."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(4, VOCAB)).astype(np.float32)
    temps, tks, seeds = [0.0, 0.8, 1.1, 0.5], [0, 0, 5, 1], [None, 3, 4, 5]
    keys = [sampling.request_key(s, r) for r, s in enumerate(seeds)]
    got = sampling.sample_tokens(torch.from_numpy(logits), VOCAB,
                                 temperatures=temps, top_ks=tks, keys=keys,
                                 steps=[2, 2, 9, 0])
    want = [ref.sample_token(jnp.asarray(logits[r]), VOCAB,
                             temperature=temps[r], top_k=tks[r],
                             key=ref.request_key(seeds[r], r),
                             step=(2, 2, 9, 0)[r]) for r in range(4)]
    assert got.tolist() == want
