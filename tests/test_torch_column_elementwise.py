"""Port device columns and Q1's element-wise functions against the JAX
package: ``batch_from_numpy``/``download`` round trips for every Q1 type
with nulls, and add/subtract/multiply and the six comparisons on inputs with
nulls and NaN, value lanes and validity both compared."""

import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arrow_tpu as at
from arrow_tpu.compute.registry import ExecContext as JaxExecContext
from arrow_tpu.compute.registry import get_function as jax_get_function
from arrow_tpu.device.column import DeviceColumn as JaxDeviceColumn
from arrow_tpu.device.column import download_table, upload_table
from arrow_tpu_torch.compute.registry import ExecContext, get_function
from arrow_tpu_torch.device.column import (DeviceColumn, batch_from_numpy,
                                           download, round_up)
from arrow_tpu_torch.types import type_for_name
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

N = 300

_JAX_TYPES = {"bool": at.bool_(), "int32": at.int32(), "int64": at.int64(),
              "float32": at.float32(), "float64": at.float64(),
              "date32": at.date32()}


def _values(type_name, rng):
    if type_name == "bool":
        return rng.integers(0, 2, N).astype(np.bool_)
    if type_name in ("int32", "date32"):
        return rng.integers(-20_000, 20_000, N).astype(np.int32)
    if type_name == "int64":
        return rng.integers(-2**62, 2**62, N).astype(np.int64)
    v = rng.normal(size=N) * 1e3
    v[::17] = np.nan
    return v.astype(np.float32 if type_name == "float32" else np.float64)


def _pylist(type_name, values, valid):
    out = []
    for v, ok in zip(values.tolist(), valid):
        if not ok:
            out.append(None)
        elif type_name == "date32":
            out.append(datetime.date(1970, 1, 1)
                       + datetime.timedelta(days=v))
        else:
            out.append(v)
    return out


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, float) and np.isnan(x):
            assert isinstance(y, float) and np.isnan(y)
        else:
            assert x == y


@pytest.mark.parametrize("type_name", ["bool", "int32", "int64", "float32",
                                       "float64", "date32", "dictionary"])
def test_round_trip_with_nulls(type_name):
    rng = np.random.default_rng(7)
    valid = rng.random(N) > 0.2
    if type_name == "dictionary":
        dictionary = ["R", "A", "N"]
        values = rng.integers(0, 3, N).astype(np.int32)
        want = [dictionary[c] if ok else None for c, ok in zip(values, valid)]
        jax_arr = at.array(want, at.dictionary(at.int32(), at.string()))
    else:
        dictionary = None
        values = _values(type_name, rng)
        want = _pylist(type_name, values, valid)
        jax_arr = at.array(want, _JAX_TYPES[type_name])
    batch = batch_from_numpy([("c", type_name, values, valid, dictionary)],
                             N, device="cpu")
    assert batch.capacity == round_up(N)
    assert batch.column("c").values.shape == (round_up(N),)
    got = download(batch)["c"]
    _same(got, want)
    jax_got = download_table(upload_table(at.table({"c": jax_arr})))
    _same(got, jax_got.to_pydict()["c"])


def test_round_trip_without_validity_and_short_row_count():
    batch = batch_from_numpy([("x", "float64", np.arange(10.0), None, None)],
                             4, device="cpu")
    assert batch.column("x").validity is None
    assert download(batch) == {"x": [0.0, 1.0, 2.0, 3.0]}


def _pair(type_name, rng, with_nulls=True):
    """The same column as a port and a JAX DeviceColumn, nulls at random."""
    cap = round_up(N)
    vals = np.zeros(cap, dtype=_values(type_name, rng).dtype)
    vals[:N] = _values(type_name, rng)
    valid = np.zeros(cap, dtype=np.bool_)
    valid[:N] = rng.random(N) > 0.25 if with_nulls else True
    t = type_for_name(type_name)
    port = DeviceColumn(torch.from_numpy(vals.copy()),
                        torch.from_numpy(valid.copy()), t)
    jax = JaxDeviceColumn(jnp.asarray(vals), jnp.asarray(valid),
                          _JAX_TYPES[type_name])
    return port, jax


def _check(port_col, jax_col):
    want = np.asarray(jax_col.values)
    got = port_col.values.numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)  # NaN lanes match as NaN
    assert (port_col.validity is None) == (jax_col.validity is None)
    if jax_col.validity is not None:
        np.testing.assert_array_equal(port_col.validity.numpy(),
                                      np.asarray(jax_col.validity))
    assert int(port_col.type.id) == int(jax_col.type.id)


_ARITH = ["add", "subtract", "multiply"]
_COMPARE = ["less", "less_equal", "greater", "greater_equal", "equal",
            "not_equal"]


@pytest.mark.parametrize("type_name", ["float64", "int64", "int32"])
@pytest.mark.parametrize("fn", _ARITH + _COMPARE)
def test_column_column(fn, type_name):
    rng = np.random.default_rng(sum(map(ord, fn + type_name)))
    pa, ja = _pair(type_name, rng)
    pb, jb = _pair(type_name, rng)
    ctx = ExecContext(pa.capacity, torch.tensor(N, dtype=torch.int32))
    jctx = JaxExecContext(ja.capacity, jnp.asarray(N, jnp.int32))
    _check(get_function(fn).impl(ctx, pa, pb),
           jax_get_function(fn).impl(jctx, ja, jb))


@pytest.mark.parametrize("literal_first", [False, True])
@pytest.mark.parametrize("fn", _ARITH + _COMPARE)
def test_column_literal_float64(fn, literal_first):
    rng = np.random.default_rng(11)
    pa, ja = _pair("float64", rng)
    ctx = ExecContext(pa.capacity, torch.tensor(N, dtype=torch.int32))
    jctx = JaxExecContext(ja.capacity, jnp.asarray(N, jnp.int32))
    args = (1.0, pa) if literal_first else (pa, 1.0)
    jargs = (1.0, ja) if literal_first else (ja, 1.0)
    _check(get_function(fn).impl(ctx, *args),
           jax_get_function(fn).impl(jctx, *jargs))


@pytest.mark.parametrize("fn", _COMPARE)
def test_date32_against_literal(fn):
    """Q1's filter: a date32 column against a day number."""
    rng = np.random.default_rng(13)
    pa, ja = _pair("date32", rng)
    ctx = ExecContext(pa.capacity, torch.tensor(N, dtype=torch.int32))
    jctx = JaxExecContext(ja.capacity, jnp.asarray(N, jnp.int32))
    _check(get_function(fn).impl(ctx, pa, 10_471),
           jax_get_function(fn).impl(jctx, ja, 10_471))


def test_arithmetic_on_dictionary_codes_raises():
    col = DeviceColumn(torch.zeros(4, dtype=torch.int32), None,
                       type_for_name("dictionary"), ("a",))
    ctx = ExecContext(4, torch.tensor(4, dtype=torch.int32))
    with pytest.raises(NotImplementedError):
        get_function("add").impl(ctx, col, col)
