"""The port's crossbar numerics (`repro_torch.xbar`) and ARAS core
algorithms (`repro_torch.core`) against the reference's on the same numpy
inputs, on the cases of `tests/test_xbar.py`, `tests/test_weight_reuse.py`
and `tests/test_replication.py`.  Integer results, histograms, ratios and
every weight-reuse decision must be exact; the dequantized dot product is
held to the Eq. 7 test's rtol 1e-6, atol 1e-5 (its f32 sums run in another
order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import replication as ref_repl
from repro.core import weight_reuse as ref_reuse
from repro.xbar import cells as ref_cells
from repro.xbar import quant as ref_quant
from repro_torch.core import replication, weight_reuse
from repro_torch.xbar import cells, quant


def _codes(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def test_pack_unpack_roundtrip_matches_reference():
    codes = np.arange(256, dtype=np.uint8)
    packed = cells.pack_cells(torch.from_numpy(codes))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(ref_cells.pack_cells(jnp.asarray(codes))))
    np.testing.assert_array_equal(cells.unpack_cells(packed).numpy(), codes)


def test_pulse_count_every_code_pair_matches_reference():
    """Every (old, new) pair of the 256 codes: pulses, per-cell pulses,
    skip ratios and the row-phase maxima."""
    a, b = np.meshgrid(np.arange(256, dtype=np.uint8),
                       np.arange(256, dtype=np.uint8))
    a, b = a.ravel(), b.ravel()
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), \
        jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_array_equal(
        cells.cell_deltas(ta, tb).numpy(),
        np.asarray(ref_cells.cell_deltas(ja, jb)))
    assert int(cells.pulse_count(ta, tb)) == int(ref_cells.pulse_count(ja, jb))
    np.testing.assert_array_equal(
        cells.pulse_count_per_cell(ta, tb).numpy(),
        np.asarray(ref_cells.pulse_count_per_cell(ja, jb)))
    for fn in ("skip_ratio", "skip_ratio_per_cell", "row_phase_pulses"):
        np.testing.assert_array_equal(
            getattr(cells, fn)(ta, tb).numpy(),
            np.asarray(getattr(ref_cells, fn)(ja, jb)), err_msg=fn)
    same = torch.from_numpy(_codes(0, 1000))
    assert float(cells.skip_ratio(same, same)) == 1.0
    assert int(cells.pulse_count(same, same)) == 0


@pytest.mark.parametrize("cell", range(cells.CELLS_PER_WEIGHT))
def test_cell_histogram_and_similarity_match_reference(cell):
    a, b = _codes(3, 4000), _codes(4, 4000)
    np.testing.assert_array_equal(
        cells.cell_value_histogram(torch.from_numpy(a), cell).numpy(),
        np.asarray(ref_cells.cell_value_histogram(jnp.asarray(a), cell)))
    got = float(cells.cell_similarity(torch.from_numpy(a),
                                      torch.from_numpy(b), cell))
    want = float(ref_cells.cell_similarity(jnp.asarray(a), jnp.asarray(b),
                                           cell))
    assert got == want and 0.0 <= got <= 1.0


def test_quantize_dequantize_shift_match_reference():
    rng = np.random.default_rng(1)
    w = rng.normal(0, 0.1, 4096).astype(np.float32)
    code, qp = quant.quantize_tensor(torch.from_numpy(w))
    rcode, rqp = ref_quant.quantize_tensor(jnp.asarray(w))
    np.testing.assert_array_equal(code.numpy(), np.asarray(rcode))
    assert float(qp.scale) == float(rqp.scale)
    assert float(qp.zero_point) == float(rqp.zero_point)
    np.testing.assert_array_equal(quant.dequantize(code, qp).numpy(),
                                  np.asarray(ref_quant.dequantize(rcode, rqp)))
    np.testing.assert_array_equal(
        quant.quantize(torch.from_numpy(w), qp).numpy(),
        np.asarray(ref_quant.quantize(jnp.asarray(w), rqp)))
    # per-channel parameters
    w2 = rng.normal(0, 0.05, (128, 32)).astype(np.float32)
    code2, qp2 = quant.quantize_tensor(torch.from_numpy(w2), axis=1)
    rcode2, rqp2 = ref_quant.quantize_tensor(jnp.asarray(w2), axis=1)
    np.testing.assert_array_equal(code2.numpy(), np.asarray(rcode2))
    np.testing.assert_array_equal(qp2.scale.numpy(), np.asarray(rqp2.scale))
    for center in (96.0, 160.0):
        shifted, off = quant.shift_weights(code2, center)
        rshifted, roff = ref_quant.shift_weights(rcode2, jnp.float32(center))
        np.testing.assert_array_equal(shifted.numpy(), np.asarray(rshifted))
        assert float(off) == float(roff)
        assert float(quant.clip_rate(code2, off)) == \
            float(ref_quant.clip_rate(rcode2, roff))


def test_dot_int8_and_eq7_shift_match_reference():
    """§V-C: the shift compensated through the zero point leaves the
    dequantized product unchanged, in both packages."""
    rng = np.random.default_rng(2)
    w = rng.normal(0, 0.05, (128, 32)).astype(np.float32)
    x = rng.normal(0, 1.0, (8, 128)).astype(np.float32)
    w_code, w_qp = quant.quantize_tensor(torch.from_numpy(w))
    x_code, x_qp = quant.quantize_tensor(torch.from_numpy(x))
    rw_code, rw_qp = ref_quant.quantize_tensor(jnp.asarray(w))
    rx_code, rx_qp = ref_quant.quantize_tensor(jnp.asarray(x))
    y = quant.dot_int8(x_code, w_code, x_qp, w_qp).numpy()
    y_ref = np.asarray(ref_quant.dot_int8(rx_code, rw_code, rx_qp, rw_qp))
    np.testing.assert_allclose(y, y_ref, rtol=1e-6, atol=1e-5)
    bias = rng.normal(size=32).astype(np.float32)
    np.testing.assert_allclose(
        quant.dot_int8(x_code, w_code, x_qp, w_qp,
                       torch.from_numpy(bias)).numpy(),
        np.asarray(ref_quant.dot_int8(rx_code, rw_code, rx_qp, rw_qp,
                                      jnp.asarray(bias))),
        rtol=1e-6, atol=1e-5)
    # codes quantized to the full [0, 255] clip at any shift: halve them
    # into [64, 191] so the shift toward either center is exact
    mid = (w_code // 2 + 64).to(torch.uint8)
    rmid = jnp.asarray(mid.numpy())
    y_mid = quant.dot_int8(x_code, mid, x_qp, w_qp)
    for center in (96.0, 160.0):
        shifted, offset = quant.shift_weights(mid, center)
        rshifted, roff = ref_quant.shift_weights(rmid, jnp.float32(center))
        np.testing.assert_array_equal(shifted.numpy(), np.asarray(rshifted))
        assert float(offset) == float(roff) != 0
        assert float(quant.clip_rate(mid, offset)) == 0.0
        y_shift = quant.dot_int8(x_code, shifted, x_qp, w_qp.shifted(offset))
        np.testing.assert_allclose(y_shift.numpy(), y_mid.numpy(), rtol=1e-6,
                                   atol=1e-5)


def _bell(rng, mean, sigma, n=20000):
    return np.clip(rng.normal(mean, sigma, n), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("case", range(6))
def test_encode_network_decisions_match_reference(case):
    """Offsets, clip rates, histograms and the chosen center, exactly —
    over `test_weight_reuse.py`'s bell-shaped layers and random ones."""
    rng = np.random.default_rng(case)
    if case == 0:
        layers = [("a", _bell(rng, 110, 20)), ("b", _bell(rng, 150, 22)),
                  ("c", _bell(rng, 135, 18))]
    elif case == 1:
        layers = [("a", _bell(rng, 128, 15)), ("b", _bell(rng, 128, 15))]
    else:
        layers = [(f"l{i}", _bell(rng, rng.uniform(60, 200),
                                  rng.uniform(5, 40),
                                  int(rng.integers(100, 30000))))
                  for i in range(int(rng.integers(1, 6)))]
    for enabled in (True, False):
        for max_clip in (1e-3, 4e-3, 0.0):
            want, wc = ref_reuse.encode_network(layers, enabled=enabled,
                                                max_clip_rate=max_clip)
            got, gc = weight_reuse.encode_network(
                [(n, torch.from_numpy(c)) for n, c in layers],
                enabled=enabled, max_clip_rate=max_clip)
            assert gc == wc
            for g, w in zip(got, want):
                assert (g.name, g.offset, g.clip_rate) == \
                    (w.name, w.offset, w.clip_rate)
                np.testing.assert_array_equal(g.hist, w.hist)
            np.testing.assert_array_equal(weight_reuse.pulse_matrix(got),
                                          ref_reuse.pulse_matrix(want))
    np.testing.assert_array_equal(
        weight_reuse.cell_hist(torch.from_numpy(layers[0][1])),
        ref_reuse.cell_hist(layers[0][1]))


@pytest.mark.parametrize("seed", range(4))
def test_plan_writes_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 9))
    spec = [dict(base_rows=int(rng.integers(1, 6)),
                 compute_cycles=int(rng.integers(10, 5000)),
                 max_replication=int(rng.integers(1, 8)),
                 write_dma_cycles=float(rng.uniform(0, 300)))
            for _ in range(n)]
    costs = [replication.LayerCost(**c) for c in spec]
    rcosts = [ref_repl.LayerCost(**c) for c in spec]
    for free in (0, 1, 3, 7, 20):
        for nxt in range(n):
            for repl in (True, False):
                got = replication.plan_writes(free, nxt, costs,
                                              lambda i: 150.0 * (i + 1), repl)
                want = ref_repl.plan_writes(free, nxt, rcosts,
                                            lambda i: 150.0 * (i + 1), repl)
                assert [tuple(vars(g).values()) for g in got] == \
                    [tuple(vars(w).values()) for w in want]
