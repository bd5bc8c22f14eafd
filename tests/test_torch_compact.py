"""The port's compaction (``move.compact_by_mask``,
``selection.compact_columns`` and ``filter_batch``) against the JAX package's ``direct`` movement path, which it takes on the
CPU.

Every dtype the port stores (bool, int32, int64, date32, float32, float64),
with and without validity, NaN payloads and -0.0, at n = 0 and ragged n,
under both null-selection modes. Tolerance: none; values, validity and the
zero tail are compared bit for bit, the count exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arrow_tpu as at
from arrow_tpu.compute.move import compact_by_mask as jax_compact_by_mask
from arrow_tpu.compute.move import movement_mode
from arrow_tpu.compute.selection import compact_column as jax_compact_column
from arrow_tpu.compute.selection import \
    compaction_indices as jax_compaction_indices
from arrow_tpu.compute.selection import filter_batch as jax_filter_batch
from arrow_tpu.device.column import DeviceBatch as JaxDeviceBatch
from arrow_tpu.device.column import DeviceColumn as JaxDeviceColumn
from arrow_tpu.table import Schema as JaxSchema
from arrow_tpu_torch.compute.move import compact_by_mask
from arrow_tpu_torch.compute.selection import compact_columns, filter_batch
from arrow_tpu_torch.device.column import DeviceBatch, DeviceColumn
from arrow_tpu_torch.types import Field, Schema, type_for_name
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

_DTYPES = ["bool", "int32", "int64", "date32", "float32", "float64"]
_NP = {"bool": np.bool_, "int32": np.int32, "int64": np.int64,
       "date32": np.int32, "float32": np.float32, "float64": np.float64}
_JAX_TYPES = {"bool": at.bool_(), "int32": at.int32(), "int64": at.int64(),
              "date32": at.date32(), "float32": at.float32(),
              "float64": at.float64()}


def _values(rng, name, n):
    if name == "bool":
        return rng.random(n) < 0.5
    if name.startswith("float"):
        v = rng.normal(size=n).astype(_NP[name])
        v[::5] = np.nan
        v[1::5] = -0.0
        if name == "float64":  # a NaN with a payload and the sign bit set
            v.view(np.int64)[2::5] = -0x0007_0000_0000_1234
        return v
    info = np.iinfo(_NP[name])
    return rng.integers(info.min, info.max, n, dtype=_NP[name],
                        endpoint=True)


def _pair(rng, name, n, with_validity):
    v = _values(rng, name, n)
    valid = rng.random(n) >= 0.2 if with_validity else None
    port = DeviceColumn(torch.from_numpy(v.copy()),
                        None if valid is None else torch.from_numpy(valid),
                        type_for_name(name))
    jax = JaxDeviceColumn(jnp.asarray(v),
                          None if valid is None else jnp.asarray(valid),
                          _JAX_TYPES[name])
    return port, jax


def _same_bits(port, jax):
    p, j = port.numpy(), np.asarray(jax)
    assert p.dtype == j.dtype and p.shape == j.shape
    assert p.tobytes() == j.tobytes()


def _same_columns(pcols, jcols):
    assert len(pcols) == len(jcols)
    for p, j in zip(pcols, jcols):
        _same_bits(p.values, j.values)
        assert (p.validity is None) == (j.validity is None)
        if j.validity is not None:
            _same_bits(p.validity, j.validity)


def test_jax_reference_runs_direct():
    assert movement_mode() == "direct"


@pytest.mark.parametrize("n", [0, 1, 1000, 4099])
@pytest.mark.parametrize("frac", [0.0, 0.5, 1.0])
def test_compact_by_mask(n, frac):
    rng = np.random.default_rng(n)
    keep = rng.random(n) < frac
    arrays = [_values(rng, name, n) for name in _DTYPES]
    outs, count = compact_by_mask(torch.from_numpy(keep),
                                  [torch.from_numpy(a) for a in arrays])
    jouts, jcount = jax_compact_by_mask(jnp.asarray(keep),
                                        [jnp.asarray(a) for a in arrays])
    assert count.dtype == torch.int32 and count.dim() == 0
    assert int(count) == int(jcount) == int(keep.sum())
    for o, j in zip(outs, jouts):
        _same_bits(o, j)


def _batches(rng, n, names, with_validity):
    pairs = [_pair(rng, name, n, with_validity) for name in names]
    fields = [f"c{i}" for i in range(len(names))]
    row_count = max(n - 3, 0)
    port = DeviceBatch(
        Schema([Field(f, type_for_name(t)) for f, t in zip(fields, names)]),
        [p for p, _ in pairs], torch.tensor(row_count, dtype=torch.int32))
    jax = JaxDeviceBatch(
        JaxSchema([at.field(f, _JAX_TYPES[t])
                   for f, t in zip(fields, names)]),
        [j for _, j in pairs], jnp.asarray(row_count, jnp.int32))
    return port, jax


@pytest.mark.parametrize("null_selection", ["drop", "emit_null"])
@pytest.mark.parametrize("with_validity", [False, True])
@pytest.mark.parametrize("n", [0, 1024, 2053])
def test_filter_batch(n, with_validity, null_selection):
    rng = np.random.default_rng(7 + n)
    port, jax = _batches(rng, n, _DTYPES, with_validity)
    mask_p, mask_j = _pair(rng, "bool", n, True)
    got = filter_batch(port, mask_p, null_selection)
    want = jax_filter_batch(jax, mask_j, null_selection)
    assert int(got.row_count) == int(want.row_count)
    _same_columns(got.columns, want.columns)


@pytest.mark.parametrize("name", _DTYPES)
@pytest.mark.parametrize("with_null", [False, True])
def test_compact_column(name, with_null):
    """One column through ``compact_columns`` against the reference's
    single-column scatter by compaction positions."""
    rng = np.random.default_rng(3)
    n = 3000
    pcol, jcol = _pair(rng, name, n, True)
    keep = rng.random(n) < 0.6
    extra = rng.random(n) < 0.1 if with_null else None
    (got,), count = compact_columns(
        [pcol], torch.from_numpy(keep),
        None if extra is None else torch.from_numpy(extra))
    jpos, jcount = jax_compaction_indices(jnp.asarray(keep))
    assert int(count) == int(jcount)
    want = jax_compact_column(jcol, jpos, None if extra is None
                              else jnp.asarray(extra))
    _same_columns([got], [want])
