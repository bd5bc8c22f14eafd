"""The port's general grouper, inner hash joins and fetch/top-k against the
JAX package.

* ``group_ids`` on keys that are not perfect-hashable (int64, date32, f64
  with nulls, NaN, -0.0, int64 extremes), single and multi-key, under a
  short row count and a filtered row mask (dead rows): group ids, group
  counts and representative rows exact.
* Inner joins run as ``Declaration`` trees over the same tables (the JAX
  package's host tables, uploaded and carried across): duplicate build keys
  (the general expansion), unique build keys (the primary-key path), null
  keys, NaN and -0.0 float keys, int64 extreme keys, two-column keys (the
  grouper path), date keys, pre-chains of filters and projects, output
  lists with suffixes, and the bloom prefilter on, off by capacity ratio,
  and disabled.
* order_by + fetch as the fused top-k and as a plain sort and fetch.

Keys, validity and row order exact; floats within rtol 1e-9 (they are only
moved, so in practice equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arrow_tpu as at
import arrow_tpu.acero as jacero
from arrow_tpu.compute.grouper import group_ids as jax_group_ids
from arrow_tpu.compute.registry import ExecContext as JaxExecContext
from arrow_tpu.device.column import DeviceColumn as JaxDeviceColumn
from arrow_tpu.device.column import upload_table
from arrow_tpu.table import Table
import arrow_tpu_torch.acero as tacero
from arrow_tpu_torch.compute.grouper import group_ids
from arrow_tpu_torch.compute.registry import ExecContext
from arrow_tpu_torch.device.column import DeviceColumn
from arrow_tpu_torch.types import type_for_name

from test_torch_q1 import assert_tables_match, carry_across
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

CAP = 4096
ROWS = 3900
I64_MIN, I64_MAX = -2**63, 2**63 - 1

_JAX_TYPES = {"int32": at.int32(), "int64": at.int64(),
              "date32": at.date32(), "float64": at.float64()}


def _key_values(rng, name, n):
    if name == "float64":
        pool = np.array([np.nan, -0.0, 0.0, 1.5, -2.25, 1e300, -np.inf],
                        dtype=np.float64)
        return pool[rng.integers(0, len(pool), n)]
    if name == "int64":
        pool = np.array([I64_MIN, I64_MAX, -1, 0, 7, 2**40],
                        dtype=np.int64)
        return pool[rng.integers(0, len(pool), n)]
    return rng.integers(9000, 9012, n).astype(np.int32)


def _key(rng, name, null_frac):
    v = _key_values(rng, name, CAP)
    valid = rng.random(CAP) >= null_frac
    port = DeviceColumn(torch.from_numpy(v.copy()),
                        torch.from_numpy(valid.copy()), type_for_name(name))
    jax = JaxDeviceColumn(jnp.asarray(v), jnp.asarray(valid),
                          _JAX_TYPES[name])
    return port, jax


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("names", [["int64"], ["date32"], ["float64"],
                                   ["int64", "date32"],
                                   ["float64", "int64", "date32"]])
def test_group_ids_general(names, filtered):
    rng = np.random.default_rng(len(names) + 10 * filtered)
    keys = [_key(rng, name, 0.1) for name in names]
    ctx = ExecContext(CAP, torch.tensor(ROWS, dtype=torch.int32))
    jctx = JaxExecContext(CAP, jnp.asarray(ROWS, jnp.int32))
    if filtered:
        keep = (rng.random(CAP) < 0.6) & (np.arange(CAP) < ROWS)
        ctx.row_mask_ = torch.from_numpy(keep.copy())
        jctx.row_mask_ = jnp.asarray(keep)
    g = group_ids(ctx, [p for p, _ in keys])
    jg = jax_group_ids(jctx, [j for _, j in keys])
    assert int(g.num_groups) == int(jg.num_groups) > 1
    np.testing.assert_array_equal(g.group_ids.numpy(),
                                  np.asarray(jg.group_ids))
    np.testing.assert_array_equal(g.rep_indices.numpy(),
                                  np.asarray(jg.rep_indices))


# --- joins --------------------------------------------------------------

def _array(values, valid, type_name):
    vals = [None if not ok else v for v, ok in zip(values.tolist(), valid)]
    return at.array(vals, _JAX_TYPES[type_name])


def _table(rng, n, spec, null_frac=0.0):
    """spec: {name: (type name, values)}; nulls at null_frac in key
    columns and payloads alike."""
    cols = {}
    for name, (type_name, values) in spec.items():
        valid = rng.random(n) >= null_frac
        cols[name] = _array(values, valid, type_name)
    return Table.from_pydict(cols)


def _join_tables(case, rng):
    """(probe table, build table, join options) for a case."""
    n_probe = 2000 if case == "bloom_off" else 5000
    n_build = 800
    kw = {}
    null_frac = 0.0
    if case == "unique_build":
        bk = rng.permutation(1000)[:n_build].astype(np.int64)
        pk = rng.integers(0, 1000, n_probe).astype(np.int64)
    elif case in ("dup_build", "bloom_off", "bloom_disabled"):
        bk = rng.integers(0, 60, n_build).astype(np.int64)
        pk = rng.integers(0, 80, n_probe).astype(np.int64)
        if case == "bloom_disabled":
            kw["disable_bloom_filter"] = True
    elif case == "null_keys":
        bk = rng.integers(0, 300, n_build).astype(np.int64)
        pk = rng.integers(0, 300, n_probe).astype(np.int64)
        null_frac = 0.1
    elif case in ("float_keys", "int64_extremes"):
        name = "float64" if case == "float_keys" else "int64"
        bk = _key_values(rng, name, n_build)
        pk = _key_values(rng, name, n_probe)
    elif case == "date_keys":
        bk = rng.permutation(np.arange(8000, 9000))[:n_build] \
            .astype(np.int32)
        pk = rng.integers(8000, 9100, n_probe).astype(np.int32)
    else:
        raise AssertionError(case)
    ktype = {np.dtype(np.float64): "float64", np.dtype(np.int32): "date32",
             np.dtype(np.int64): "int64"}[bk.dtype]
    probe = _table(rng, n_probe, {
        "pk": (ktype, pk),
        "pv": ("float64", rng.normal(size=n_probe)),
        "x": ("int32", rng.integers(0, 10, n_probe).astype(np.int32))},
        null_frac)
    build = _table(rng, n_build, {
        "bk": (ktype, bk),
        "bv": ("int64", rng.integers(-10**9, 10**9, n_build)),
        "x": ("int32", rng.integers(0, 10, n_build).astype(np.int32))},
        null_frac)
    kw.update(left_keys=["pk"], right_keys=["bk"])
    return probe, build, kw


def _multi_key_tables(rng):
    n_probe, n_build = 5000, 700
    probe = _table(rng, n_probe, {
        "a": ("int64", rng.integers(0, 20, n_probe)),
        "b": ("int32", rng.integers(0, 6, n_probe).astype(np.int32)),
        "pv": ("float64", rng.normal(size=n_probe))}, 0.05)
    build = _table(rng, n_build, {
        "ba": ("int64", rng.integers(0, 20, n_build)),
        "bb": ("int64", rng.integers(0, 6, n_build)),
        "bv": ("int32", rng.integers(0, 1000, n_build).astype(np.int32))},
        0.05)
    return probe, build, dict(left_keys=["a", "b"], right_keys=["ba", "bb"])


def _run_both(make, probe, build):
    want = make(jacero, probe, build).to_table().to_pydict()
    got = make(tacero, carry_across(upload_table(probe)),
               carry_across(upload_table(build))).to_table().to_pydict()
    return got, want


def _join_plan(mod, probe, build, **kw):
    src = mod.Declaration
    return src("hashjoin", mod.HashJoinNodeOptions("inner", **kw), inputs=[
        src("table_source", mod.TableSourceNodeOptions(probe)),
        src("table_source", mod.TableSourceNodeOptions(build))])


_CASES = ["dup_build", "unique_build", "null_keys", "float_keys",
          "int64_extremes", "date_keys", "bloom_off", "bloom_disabled"]


@pytest.mark.parametrize("case", _CASES)
def test_inner_join(case):
    probe, build, kw = _join_tables(case, np.random.default_rng(
        _CASES.index(case)))
    got, want = _run_both(
        lambda mod, p, b: _join_plan(mod, p, b, output_suffix_for_left="_l",
                                     output_suffix_for_right="_r", **kw),
        probe, build)
    assert len(got["pk"]) > 0
    assert list(got) == ["pk", "pv", "x_l", "bk", "bv", "x_r"]
    assert_tables_match(got, want)


def test_inner_join_multi_key():
    probe, build, kw = _multi_key_tables(np.random.default_rng(20))
    got, want = _run_both(lambda mod, p, b: _join_plan(mod, p, b, **kw),
                          probe, build)
    assert len(got["a"]) > 0
    assert_tables_match(got, want)


def test_join_pre_chains_and_output_lists():
    """Filters and projects above both inputs run before the join (and
    before the bloom filter); the output lists pick and order columns."""
    probe, build, kw = _join_tables("dup_build", np.random.default_rng(30))

    def make(mod, p, b):
        field = mod.field
        src = mod.Declaration
        left = src.from_sequence([
            src("table_source", mod.TableSourceNodeOptions(p)),
            src("filter", mod.FilterNodeOptions(field("x") < 7)),
            src("project", mod.ProjectNodeOptions(
                [field("pk"), field("pv") * 2.0], ["pk", "pv2"]))])
        right = src.from_sequence([
            src("table_source", mod.TableSourceNodeOptions(b)),
            src("filter", mod.FilterNodeOptions(field("x") > 2))])
        return src("hashjoin", mod.HashJoinNodeOptions(
            "inner", left_keys=["pk"], right_keys=["bk"],
            left_output=["pv2", "pk"], right_output=["bv"]),
            inputs=[left, right])

    got, want = _run_both(make, probe, build)
    assert list(got) == ["pv2", "pk", "bv"] and len(got["pk"]) > 0
    assert_tables_match(got, want)


def _sorted_plan(mod, probe, build, offset, count):
    src = mod.Declaration
    return src.from_sequence([
        _join_plan(mod, probe, build, left_keys=["pk"], right_keys=["bk"],
                   right_output=["bv"]),
        src("order_by", mod.OrderByNodeOptions(
            [("pv", "descending"), ("bv", "ascending")])),
        src("fetch", mod.FetchNodeOptions(offset, count))])


@pytest.mark.parametrize("offset,count", [(0, 10), (5, 1000), (3, 2000),
                                          (0, 100_000)])
def test_order_by_fetch(offset, count):
    """(0, 10) and (5, 1000) run as the fused top-k, the others as a sort
    and a fetch."""
    probe, build, _ = _join_tables("null_keys", np.random.default_rng(40))
    got, want = _run_both(
        lambda mod, p, b: _sorted_plan(mod, p, b, offset, count),
        probe, build)
    assert len(got["pk"]) == len(want["pk"]) > 0
    assert_tables_match(got, want)


@pytest.mark.parametrize("offset,count", [(0, 7), (11, 30), (4990, 100)])
def test_fetch_without_sort(offset, count):
    probe, _, _ = _join_tables("dup_build", np.random.default_rng(50))

    def make(mod, p, _b):
        src = mod.Declaration
        return src.from_sequence([
            src("table_source", mod.TableSourceNodeOptions(p)),
            src("fetch", mod.FetchNodeOptions(offset, count))])

    got, want = _run_both(make, probe, probe)
    assert len(got["pk"]) == min(count, 5000 - offset)
    assert_tables_match(got, want)
