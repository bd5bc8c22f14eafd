"""The port's key hashing and bloom filter against the JAX package.

``kernels.hash32.hash32`` (its plain version on the CPU) against
``hash32_words`` for 1 to 3 words a row with the edge words 0, 0x80000000
and 0xFFFFFFFF; the bloom's key hashes over the equality words of every
stored dtype and of several columns; bloom words and
queries for int64, date32, f64 (NaN, -0.0) and two-column keys, dead rows
included, so the reference's wrapped -1 scatter (bit 31 of the last word)
is reproduced. Tolerance: none; hashes and words are compared bit for
bit, query results exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arrow_tpu as at
from arrow_tpu.compute import bloom as jax_bloom
from arrow_tpu.compute.hashing import hash32_words as jax_hash32_words
from arrow_tpu.device.column import DeviceColumn as JaxDeviceColumn
from arrow_tpu_torch.compute import bloom
from arrow_tpu_torch.device.column import DeviceColumn
from arrow_tpu_torch.kernels.hash32 import hash32
from arrow_tpu_torch.types import type_for_name
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

_EDGE = np.array([0, 0x80000000, 0xFFFFFFFF, 1, 0x7FFFFFFF],
                 dtype=np.uint32)
_JAX_TYPES = {"bool": at.bool_(), "int32": at.int32(), "int64": at.int64(),
              "date32": at.date32(), "float32": at.float32(),
              "float64": at.float64()}
_NP = {"bool": np.bool_, "int32": np.int32, "int64": np.int64,
       "date32": np.int32, "float32": np.float32, "float64": np.float64}


def _u32(h):
    return np.asarray(h).view(np.uint32) if np.asarray(h).dtype == np.int32 \
        else np.asarray(h)


def _words(rng, n, k):
    out = []
    for _ in range(k):
        w = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        w[:len(_EDGE)] = _EDGE
        w[len(_EDGE):2 * len(_EDGE)] = _EDGE[::-1]
        out.append(w)
    return out


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("n", [5, 4099])
def test_hash32_words_bit_exact(k, n):
    words = _words(np.random.default_rng(k * n), max(n, 10), k)
    got = hash32([torch.from_numpy(w.view(np.int32)) for w in words])
    want = jax_hash32_words([jnp.asarray(w) for w in words])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got.numpy()), np.asarray(want))


def _column(rng, name, n, null_frac=0.0, special=True):
    if name == "bool":
        v = rng.random(n) < 0.5
    elif name.startswith("float"):
        v = (rng.normal(size=n) * 1e6).astype(_NP[name])
        if special:
            v[::11] = np.nan
            v[1::11] = -0.0
            v[2::11] = 0.0
    else:
        info = np.iinfo(_NP[name])
        v = rng.integers(info.min, info.max, n, dtype=_NP[name],
                         endpoint=True)
        if special:
            v[:3] = [info.min, info.max, -1]
    valid = None if not null_frac else rng.random(n) >= null_frac
    port = DeviceColumn(torch.from_numpy(v.copy()),
                        None if valid is None else torch.from_numpy(valid),
                        type_for_name(name))
    jax = JaxDeviceColumn(jnp.asarray(v),
                          None if valid is None else jnp.asarray(valid),
                          _JAX_TYPES[name])
    return port, jax


@pytest.mark.parametrize("names", [["bool"], ["int32"], ["int64"],
                                   ["date32"], ["float32"], ["float64"],
                                   ["int64", "float64", "int32"]])
def test_hash_columns_bit_exact(names):
    """The bloom's hash of key columns: two words per equality word."""
    rng = np.random.default_rng(len(names))
    pairs = [_column(rng, name, 2048) for name in names]
    got = bloom._key_hashes([p for p, _ in pairs])
    want = jax_bloom._key_hashes([j for _, j in pairs])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [0, 100, 10_000, 10**7])
def test_log_bits_for(n):
    assert bloom.log_bits_for(n) == jax_bloom.log_bits_for(n)


_KEYS = {"int64": ["int64"], "date32": ["date32"], "float64": ["float64"],
         "two": ["int64", "int32"]}


def _bloom_case(keys, dead_frac, seed, n=3000):
    rng = np.random.default_rng(seed)
    pairs = [_column(rng, name, n, null_frac=0.05) for name in _KEYS[keys]]
    live = rng.random(n) >= dead_frac
    for p, _ in pairs:
        live &= p.validity.numpy()
    return rng, pairs, live


@pytest.mark.parametrize("dead_frac", [0.0, 0.3])
@pytest.mark.parametrize("keys", sorted(_KEYS))
def test_bloom_words_bit_identical(keys, dead_frac):
    _, pairs, live = _bloom_case(keys, dead_frac, 1)
    lb = bloom.log_bits_for(len(live))
    got = bloom.build_bloom([p for p, _ in pairs], torch.from_numpy(live),
                            lb)
    want = jax_bloom.build_bloom([j for _, j in pairs], jnp.asarray(live),
                                 lb)
    assert got.log_words == want.log_words
    np.testing.assert_array_equal(got.words.numpy().astype(np.uint32),
                                  np.asarray(want.words))
    # null keys are dead rows here: the wrapped -1 sets bit 31 of the
    # last word, in the reference and in the port
    assert not live.all()
    assert int(got.words[-1]) >> 31 == 1


@pytest.mark.parametrize("keys", sorted(_KEYS))
def test_bloom_query_identical(keys):
    rng, pairs, live = _bloom_case(keys, 0.2, 2)
    lb = bloom.log_bits_for(len(live))
    bf = bloom.build_bloom([p for p, _ in pairs], torch.from_numpy(live), lb)
    jbf = jax_bloom.build_bloom([j for _, j in pairs], jnp.asarray(live), lb)
    # probes: the build keys (no false negatives) and fresh keys
    fresh = [_column(rng, name, 3000, null_frac=0.05)
             for name in _KEYS[keys]]
    for probe in (pairs, fresh):
        p_live = rng.random(3000) >= 0.1
        got = bloom.bloom_query(bf, [p for p, _ in probe],
                                torch.from_numpy(p_live))
        want = jax_bloom.bloom_query(jbf, [j for _, j in probe],
                                     jnp.asarray(p_live))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = bloom.bloom_query(bf, [p for p, _ in pairs],
                            torch.from_numpy(live))
    assert bool(got[torch.from_numpy(live)].all())
