"""The grouped-sum kernel's plain version (arrow_tpu_torch/kernels/
grouped_sum.py, the path a CPU tensor takes) against the TPU kernels it
replaces, run in Pallas interpret mode: K1 (experimental/pallas_agg.py) at
8, 12 and 128 groups and K3 (compute/pallas_move.py) at 512 groups. Value
regimes and tolerances are those of tests/test_pallas_agg.py. Each
interpret-mode call costs seconds, so every regime shares one call per
group count. The kernel itself runs only on the card:
tests/test_torch_kernels_cuda.py holds it against the plain version there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_tpu.compute.pallas_move import grouped_sum_pallas as k3_pallas
from arrow_tpu.experimental.pallas_agg import grouped_sum_pallas as k1_pallas
from arrow_tpu_torch.kernels.grouped_sum import (MAX_SEGMENTS, grouped_sum,
                                                 grouped_sum_plain)
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

_PER = 500


def _regimes(rng, per):
    return [
        rng.uniform(1.0, 100000.0, per),           # 0: TPC-H price scale
        rng.normal(size=per),                      # 1: signed, cancel-y
        rng.uniform(-1e-3, 1e-3, per),             # 2: small magnitudes
        rng.uniform(1e6, 1e9, per),                # 3: large magnitudes
        np.concatenate([np.zeros(per - 3),
                        [1e-40, -1e-40, 5e-324]]),  # 4: zeros + denormals
        np.concatenate([rng.normal(size=per - 1), [np.inf]]),   # 5: inf
        np.concatenate([rng.normal(size=per - 1), [np.nan]]),   # 6: nan
        -rng.uniform(1.0, 100.0, per),             # 7: all negative
    ]


def _regime_inputs(num_segments, seed):
    """Regime r fills group slots[r]; the other groups stay empty."""
    rng = np.random.default_rng(seed)
    slots = np.linspace(0, num_segments - 1, 8).astype(np.int32)
    v = np.concatenate(_regimes(rng, _PER))
    g = np.repeat(slots, _PER)
    perm = rng.permutation(v.shape[0])
    return v[perm], g[perm], slots


def _check_regimes(out, v, g, slots, num_segments):
    ref = np.zeros(num_segments)
    np.add.at(ref, g, v)
    for r in (0, 1, 2, 3, 7):
        np.testing.assert_allclose(out[slots[r]], ref[slots[r]], rtol=1e-10,
                                   err_msg=f"regime {r}")
    np.testing.assert_allclose(out[slots[4]], ref[slots[4]], atol=1e-30)
    assert np.isinf(out[slots[5]]) and out[slots[5]] > 0
    assert np.isnan(out[slots[6]])
    empty = np.setdiff1d(np.arange(num_segments), slots)
    assert np.all(out[empty] == 0.0)


def _port(v, g, num_segments):
    return grouped_sum(torch.from_numpy(v), torch.from_numpy(g),
                       num_segments).numpy()


@pytest.mark.parametrize("num_segments", [8, 12, 128])
def test_f64_regimes_against_k1(num_segments):
    v, g, slots = _regime_inputs(num_segments, num_segments)
    k1 = np.asarray(k1_pallas(jnp.asarray(v), jnp.asarray(g), num_segments,
                              interpret=True, block_rows=8))
    port = _port(v, g, num_segments)
    assert port.dtype == np.float64
    _check_regimes(k1, v, g, slots, num_segments)
    _check_regimes(port, v, g, slots, num_segments)
    fin = np.isfinite(k1)
    np.testing.assert_allclose(port[fin], k1[fin], rtol=1e-10, atol=1e-30)
    assert np.array_equal(np.isnan(port), np.isnan(k1))
    assert np.array_equal(np.isinf(port), np.isinf(k1))


def test_f64_regimes_against_k3_at_512_groups():
    v, g, slots = _regime_inputs(512, 512)
    k3 = np.asarray(k3_pallas(jnp.asarray(v), jnp.asarray(g), 512,
                              interpret=True, block_rows=8))
    port = _port(v, g, 512)
    _check_regimes(k3, v, g, slots, 512)
    _check_regimes(port, v, g, slots, 512)
    fin = np.isfinite(k3)
    np.testing.assert_allclose(port[fin], k3[fin], rtol=1e-10, atol=1e-30)


def test_f32_accuracy_against_k1():
    rng = np.random.default_rng(2)
    n = 4_000
    v = rng.uniform(0, 1000, n).astype(np.float32)
    g = rng.integers(0, 16, n).astype(np.int32)
    ref = np.zeros(16)
    np.add.at(ref, g, v.astype(np.float64))
    k1 = np.asarray(k1_pallas(jnp.asarray(v), jnp.asarray(g), 16,
                              interpret=True, block_rows=8))
    port = _port(v, g, 16)
    assert port.dtype == np.float32
    np.testing.assert_allclose(port.astype(np.float64), ref, rtol=1e-5)
    np.testing.assert_allclose(port, k1, rtol=1e-5)


@pytest.mark.parametrize("num_segments", [0, MAX_SEGMENTS + 1])
def test_num_segments_out_of_range_raises(num_segments):
    with pytest.raises(ValueError):
        grouped_sum(torch.zeros(10, dtype=torch.float64),
                    torch.zeros(10, dtype=torch.int32), num_segments)


def test_rejects_wrong_dtypes():
    with pytest.raises(ValueError):
        grouped_sum(torch.zeros(10, dtype=torch.int64),
                    torch.zeros(10, dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        grouped_sum(torch.zeros(10, dtype=torch.float64),
                    torch.zeros(10, dtype=torch.int64), 4)


def test_cpu_call_launches_nothing():
    grouped_sum.launches = 0
    out = grouped_sum(torch.ones(100, dtype=torch.float64),
                      torch.zeros(100, dtype=torch.int32), 12)
    assert out[0] == 100.0 and grouped_sum.launches == 0
