"""The port's perfect-hash grouper and grouped sum/mean/count/count_all
against the JAX package on dictionary keys with nulls, under a row mask
(a short row count and a folded filter). Group ids, group counts and
representative rows are exact; counts and validity exact; float results
within rtol 1e-9 (sums are reassociated)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arrow_tpu as at
from arrow_tpu.compute import hash_agg as jax_hash_agg
from arrow_tpu.compute.grouper import group_ids as jax_group_ids
from arrow_tpu.compute.grouper import \
    group_slot_bound_exact as jax_slot_bound
from arrow_tpu.compute.registry import ExecContext as JaxExecContext
from arrow_tpu.device.column import DeviceColumn as JaxDeviceColumn
from arrow_tpu_torch.compute import hash_agg
from arrow_tpu_torch.compute.grouper import (group_capacity_bound,
                                             group_ids,
                                             group_slot_bound_exact)
from arrow_tpu_torch.compute.registry import ExecContext
from arrow_tpu_torch.device.column import DeviceColumn
from arrow_tpu_torch.types import type_for_name
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

CAP = 4096
ROWS = 3500

_JAX_TYPES = {"float64": at.float64(), "float32": at.float32(),
              "int64": at.int64(), "int32": at.int32()}


def _dict_key(rng, values, null_frac):
    codes = rng.integers(0, len(values), CAP).astype(np.int32)
    valid = rng.random(CAP) >= null_frac
    port = DeviceColumn(torch.from_numpy(codes.copy()),
                        torch.from_numpy(valid.copy()),
                        type_for_name("dictionary"), tuple(values))
    jax = JaxDeviceColumn(jnp.asarray(codes), jnp.asarray(valid),
                          at.dictionary(at.int32(), at.string()),
                          at.array(list(values), at.string()))
    return port, jax


def _value_col(rng, type_name, null_frac=0.1):
    if type_name.startswith("float"):
        v = (rng.normal(size=CAP) * 1e4).astype(type_name)
        v[::97] = np.nan
    else:
        v = rng.integers(-10**6, 10**6, CAP).astype(type_name)
    valid = rng.random(CAP) >= null_frac
    port = DeviceColumn(torch.from_numpy(v.copy()),
                        torch.from_numpy(valid.copy()),
                        type_for_name(type_name))
    jax = JaxDeviceColumn(jnp.asarray(v), jnp.asarray(valid),
                          _JAX_TYPES[type_name])
    return port, jax


def _contexts(rng, filtered):
    ctx = ExecContext(CAP, torch.tensor(ROWS, dtype=torch.int32))
    jctx = JaxExecContext(CAP, jnp.asarray(ROWS, jnp.int32))
    if filtered:
        keep = (rng.random(CAP) < 0.7) & (np.arange(CAP) < ROWS)
        ctx.row_mask_ = torch.from_numpy(keep.copy())
        jctx.row_mask_ = jnp.asarray(keep)
    return ctx, jctx


def _setup(seed, filtered, key_specs):
    rng = np.random.default_rng(seed)
    keys = [_dict_key(rng, vals, nf) for vals, nf in key_specs]
    ctx, jctx = _contexts(rng, filtered)
    return rng, ctx, jctx, [k[0] for k in keys], [k[1] for k in keys]


_KEY_SPECS = {
    "q1": [(("R", "A", "N"), 0.05), (("O", "F"), 0.0)],
    "one": [(("x", "y", "z", "w", "v"), 0.2)],
    "three": [(("a", "b"), 0.1), (("c", "d", "e"), 0.0),
              (("f", "g", "h", "i"), 0.3)],
}


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("keys", sorted(_KEY_SPECS))
def test_group_ids_perfect(keys, filtered):
    _, ctx, jctx, pkeys, jkeys = _setup(1, filtered, _KEY_SPECS[keys])
    g = group_ids(ctx, pkeys)
    jg = jax_group_ids(jctx, jkeys)
    assert int(g.num_groups) == int(jg.num_groups)
    np.testing.assert_array_equal(g.group_ids.numpy(),
                                  np.asarray(jg.group_ids))
    np.testing.assert_array_equal(g.rep_indices.numpy(),
                                  np.asarray(jg.rep_indices))
    assert group_slot_bound_exact(pkeys, CAP) == jax_slot_bound(jkeys, CAP)
    assert group_capacity_bound(pkeys, CAP) == 1024


def _compare_column(port, jax, nseg, rtol):
    assert int(port.count) == int(jax.count)
    pv, jv = port.column.values.numpy(), np.asarray(jax.column.values)
    assert pv.shape == jv.shape == (nseg,)
    assert pv.dtype == jv.dtype
    assert int(port.column.type.id) == int(jax.column.type.id)
    if jax.column.validity is not None:
        np.testing.assert_array_equal(port.column.validity.numpy(),
                                      np.asarray(jax.column.validity))
    if pv.dtype.kind == "f":
        np.testing.assert_allclose(pv, jv, rtol=rtol, atol=0,
                                   equal_nan=True)
    else:
        np.testing.assert_array_equal(pv, jv)


_AGG_CASES = [
    ("hash_sum", "float64", {}), ("hash_sum", "float32", {}),
    ("hash_sum", "int64", {}), ("hash_sum", "int32", {}),
    ("hash_mean", "float64", {}), ("hash_mean", "int64", {}),
    ("hash_count", "float64", {}),
]

# options Q1 does not use (ported with the aggregates, item 9.7)
_UNPORTED_OPTS = [
    ("hash_sum", {"min_count": 0}), ("hash_sum", {"skip_nulls": False}),
    ("hash_mean", {"skip_nulls": False}),
    ("hash_count", {"mode": "only_null"}), ("hash_count", {"mode": "all"}),
]


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("fname,type_name,opts", _AGG_CASES)
def test_grouped_aggregates(fname, type_name, opts, filtered):
    rng, ctx, jctx, pkeys, jkeys = _setup(2, filtered, _KEY_SPECS["q1"])
    g = group_ids(ctx, pkeys)
    jg = jax_group_ids(jctx, jkeys)
    nseg = group_slot_bound_exact(pkeys, CAP)
    pcol, jcol = _value_col(rng, type_name)
    port = getattr(hash_agg, _PY_NAMES[fname])(
        ctx, pcol, g.group_ids, g.num_groups, num_segments=nseg, **opts)
    jax = getattr(jax_hash_agg, _PY_NAMES[fname])(
        jctx, jcol, jg.group_ids, jg.num_groups, num_segments=nseg, **opts)
    _compare_column(port, jax, nseg, 1e-9)


_PY_NAMES = {"hash_sum": "grouped_sum", "hash_mean": "grouped_mean",
             "hash_count": "grouped_count"}


@pytest.mark.parametrize("fname,opts", _UNPORTED_OPTS)
def test_unported_options_raise(fname, opts):
    """These options raised until the aggregates were ported (ROADMAP.md
    queue 1, item 9.7); each now gives the reference's groups, validity
    included, at the node's segment bound."""
    rng, ctx, jctx, pkeys, jkeys = _setup(2, False, _KEY_SPECS["q1"])
    g = group_ids(ctx, pkeys)
    jg = jax_group_ids(jctx, jkeys)
    nseg = group_slot_bound_exact(pkeys, CAP)
    pcol, jcol = _value_col(rng, "float64")
    port = getattr(hash_agg, _PY_NAMES[fname])(
        ctx, pcol, g.group_ids, g.num_groups, num_segments=nseg, **opts)
    jax = getattr(jax_hash_agg, _PY_NAMES[fname])(
        jctx, jcol, jg.group_ids, jg.num_groups, num_segments=nseg, **opts)
    _compare_column(port, jax, nseg, 1e-9)


@pytest.mark.parametrize("filtered", [False, True])
def test_grouped_count_all(filtered):
    _, ctx, jctx, pkeys, jkeys = _setup(3, filtered, _KEY_SPECS["three"])
    g = group_ids(ctx, pkeys)
    jg = jax_group_ids(jctx, jkeys)
    nseg = group_slot_bound_exact(pkeys, CAP)
    port = hash_agg.grouped_count_all(ctx, g.group_ids, g.num_groups,
                                      num_segments=nseg)
    jax = jax_hash_agg.grouped_count_all(jctx, jg.group_ids, jg.num_groups,
                                         num_segments=nseg)
    _compare_column(port, jax, nseg, 0)


def test_non_perfect_keys_raise():
    """Keys that are not perfect-hashable no longer raise: they take the
    general grouper, which agrees with the reference and reduces at the
    row capacity."""
    v = np.arange(CAP, dtype=np.int64) % 7
    col = DeviceColumn(torch.from_numpy(v), None, type_for_name("int64"))
    jcol = JaxDeviceColumn(jnp.asarray(v), None, at.int64())
    ctx = ExecContext(CAP, torch.tensor(ROWS, dtype=torch.int32))
    jctx = JaxExecContext(CAP, jnp.asarray(ROWS, jnp.int32))
    g = group_ids(ctx, [col])
    jg = jax_group_ids(jctx, [jcol])
    assert int(g.num_groups) == int(jg.num_groups) == 7
    np.testing.assert_array_equal(g.group_ids.numpy(),
                                  np.asarray(jg.group_ids))
    np.testing.assert_array_equal(g.rep_indices.numpy(),
                                  np.asarray(jg.rep_indices))
    assert group_slot_bound_exact([col], CAP) == CAP
    assert group_capacity_bound([col], CAP) == CAP
